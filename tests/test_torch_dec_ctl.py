"""The port's decoder controls against the JAX package on the CPU: the
telemetry overlays (and the native per-fragment bit counts they draw),
the striped-decode callback, the `th_*` decode API (compat.py) and
`tools/dec.py --pp/--telemetry`."""
import os

import numpy as np
import pytest

from tests.conftest import TESTDATA
from theora_tpu import compat as jax_compat
from theora_tpu.decode.decoder import Decoder as JaxDecoder
from theora_tpu.headers import parse_info_header as jax_info
from theora_tpu.headers import parse_setup_header as jax_setup
from theora_tpu.tpkt import Packet as JaxPacket
from theora_tpu.tpkt import read_tpkt
from theora_tpu_torch import compat
from theora_tpu_torch.decode.batch import BatchDecoder
from theora_tpu_torch.decode.scalar import PacketDecoder, stripe_rows
from theora_tpu_torch.headers import parse_info_header, parse_setup_header
from theora_tpu_torch.tpkt import Packet

FLAGS = ("mbmode", "mv", "qi", "bits")


def _frame_bytes(frame) -> bytes:
    return b"".join(np.ascontiguousarray(p).tobytes() for p in frame)


def _load(name):
    pkts = read_tpkt(os.path.join(TESTDATA, f"{name}.tpkt"))
    return pkts, parse_info_header(pkts[0].data), \
        parse_setup_header(pkts[2].data)


@pytest.fixture(scope="module")
def clip():
    return _load("clip64x48_k8_q5")


@pytest.fixture(scope="module")
def cif():
    return _load("cif_k4_q40")


@pytest.fixture(scope="module")
def crop():
    """Every overlay changes its frames (cropped picture, motion, three
    qis)."""
    return _load("crop80x64")


def _jax_frames(pkts, datas, level=0, **tele):
    dec = JaxDecoder(jax_info(pkts[0].data), jax_setup(pkts[2].data))
    dec.set_pplevel(level)
    dec.set_telemetry(**tele)
    out = []
    for d in datas:
        dec.decode_packet(d)
        out.append(_frame_bytes(dec.ycbcr_out()))
    return out


# -------------------------------------------------------------- telemetry

@pytest.mark.parametrize("flags", [(f,) for f in FLAGS] + [FLAGS])
def test_telemetry_overlays_equal_jax(crop, flags):
    """Each overlay alone and all four together, drawn on the downloaded
    frame, equal JAX's host Decoder, per packet and by decode_clip, a dup
    packet included; the overlays change the frames."""
    pkts, info, setup = crop
    datas = [p.data for p in pkts[3:9]]
    datas = datas[:3] + [b""] + datas[3:]
    tele = {f: 1 for f in flags}
    want = _jax_frames(pkts, datas, **tele)
    assert want != _jax_frames(pkts, datas)
    pd = PacketDecoder(info, setup, device="cpu")
    pd.set_telemetry(**tele)
    got = []
    for d in datas:
        pd.decode_packet(d)
        got.append(_frame_bytes(pd.ycbcr_out()))
    assert got == want
    bd = BatchDecoder(info, setup, device="cpu")
    bd.set_telemetry(**tele)
    assert [_frame_bytes(f) for f in bd.decode_clip(datas, batch=3)] == want


def test_telemetry_with_pp_equals_jax(clip):
    """All four overlays over the pp 7 output."""
    pkts, info, setup = clip
    datas = [p.data for p in pkts[3:]]
    tele = {f: 1 for f in FLAGS}
    want = _jax_frames(pkts, datas, level=7, **tele)
    bd = BatchDecoder(info, setup, device="cpu")
    bd.set_pplevel(7)
    bd.set_telemetry(**tele)
    assert [_frame_bytes(f) for f in bd.decode_clip(datas, batch=8)] == want


def test_frag_bits_equal_the_jax_native(cif):
    """The native token decode's per-fragment bit counts equal the JAX
    package's native ones, packet for packet."""
    from theora_tpu.native import NativeEntropy as JaxNative

    pkts, info, setup = cif
    dec = BatchDecoder(info, setup, device="cpu")
    jnat = JaxNative(jax_setup(pkts[2].data).codebooks)
    for p in pkts[3:11]:
        side = dec._parse_sideinfo_native(p.data)
        coded = side["coded"]
        nc = [len(f[coded[f]]) for f in dec._scan_by_plane]
        got = dec._native.decode_frame_tokens(p.data, side["bitpos"], nc,
                                              want_bits=True)
        want = jnat.decode_frame_tokens(p.data, side["bitpos"], nc,
                                        want_bits=True)
        assert len(got) == 5 and got[4].sum() > 0
        for a, b in zip(got, want):
            assert np.array_equal(np.asarray(a), np.asarray(b))
        assert len(dec._native.decode_frame_tokens(p.data, side["bitpos"],
                                                   nc)) == 4


# -------------------------------------------------------- stripe callback

def _collect(log):
    def cb(ycbcr, a, b):
        log.append((a, b, [p[(a * 8) >> (1 if i and ycbcr[i].shape[0]
                                         < ycbcr[0].shape[0] else 0):
                             (b * 8) >> (1 if i and ycbcr[i].shape[0]
                                         < ycbcr[0].shape[0] else 0)].copy()
                           for i, p in enumerate(ycbcr)]))
    return cb


def _stripes(dec, datas):
    log = []
    dec.stripe_callback = _collect(log)
    frames = []
    for d in datas:
        log.append("packet")
        dec.decode_packet(d)
        frames.append(_frame_bytes(dec.ycbcr_out()))
    return log, frames


@pytest.mark.parametrize("name,level,tele", [
    ("clip64x48_k8_q5", 0, {}), ("clip64x48_k8_q5", 7, {}),
    ("cif_k4_q40", 0, {}), ("cif_k4_q40", 0, {"mv": 1}),
    ("clip422", 0, {}), ("clip444", 5, {}),
])
def test_stripe_callback_equals_jax(name, level, tele):
    """The same (yfrag0, yfrag_end) sequence as the JAX decoder and the
    same rows delivered in each call (final rows), with and without pp or
    an overlay, on streams whose frames filter; none for a dup."""
    pkts, info, setup = _load(name)
    datas = [p.data for p in pkts[3:8]]
    datas = datas[:2] + [b""] + datas[2:]
    jd = JaxDecoder(jax_info(pkts[0].data), jax_setup(pkts[2].data))
    jd.set_pplevel(level)
    jd.set_telemetry(**tele)
    want_log, want_frames = _stripes(jd, datas)
    pd = PacketDecoder(info, setup, device="cpu")
    pd.set_pplevel(level)
    pd.set_telemetry(**tele)
    got_log, got_frames = _stripes(pd, datas)
    assert got_frames == want_frames
    assert len(got_log) == len(want_log)
    for g, w in zip(got_log, want_log):
        if g == "packet" or w == "packet":
            assert g == w
            continue
        assert g[:2] == w[:2]
        for a, b in zip(g[2], w[2]):
            assert np.array_equal(a, b)
    assert sum(1 for e in got_log if e != "packet") > len(datas)


def test_stripe_rows_sequences():
    """The pair sequences of the striped filter: one filtered row behind
    on every stripe but the last, luma and 4:2:0 chroma agreeing."""
    assert stripe_rows(6, 3, 1, True) == [(4, 6), (0, 4)]
    assert stripe_rows(6, 3, 1, False) == [(2, 6), (0, 2)]
    assert stripe_rows(36, 18, 1, True)[:3] == [(34, 36), (30, 34),
                                                (26, 30)]
    assert stripe_rows(8, 8, 0, True) == [(5, 8), (0, 5)]


def test_batch_entries_raise_with_a_stripe_callback(clip):
    pkts, info, setup = clip
    datas = [p.data for p in pkts[3:]]
    dec = PacketDecoder(info, setup, device="cpu")
    dec.stripe_callback = lambda *a: None
    with pytest.raises(ValueError, match="stripe callback"):
        dec.decode_batch(datas[:2])
    with pytest.raises(ValueError, match="stripe callback"):
        dec.decode_clip(datas, batch=4)
    dec.stripe_callback = None
    assert len(dec.decode_clip(datas, batch=4)) == len(datas)


# ------------------------------------------------------- th_* decode API

def _ctx_pair(pkts, info, setup):
    j = jax_compat.th_decode_alloc({"info": jax_info(pkts[0].data),
                                    "setup": jax_setup(pkts[2].data)})
    p = compat.th_decode_alloc({"info": info, "setup": setup}, device="cpu")
    return j, p


@pytest.mark.parametrize("req,buf", [
    (compat.TH_DECCTL_GET_PPLEVEL_MAX, None),
    (compat.TH_DECCTL_SET_PPLEVEL, 0), (compat.TH_DECCTL_SET_PPLEVEL, 7),
    (compat.TH_DECCTL_SET_PPLEVEL, 8), (compat.TH_DECCTL_SET_PPLEVEL, -1),
    (compat.TH_DECCTL_SET_PPLEVEL, "3"), (compat.TH_DECCTL_SET_PPLEVEL, None),
    (compat.TH_DECCTL_SET_GRANPOS, 0), (compat.TH_DECCTL_SET_GRANPOS, 77),
    (compat.TH_DECCTL_SET_GRANPOS, -1), (compat.TH_DECCTL_SET_GRANPOS, None),
    (compat.TH_DECCTL_SET_STRIPE_CB, None),
    (compat.TH_DECCTL_SET_TELEMETRY_MBMODE, 1),
    (compat.TH_DECCTL_SET_TELEMETRY_MV, 0),
    (compat.TH_DECCTL_SET_TELEMETRY_QI, 2),
    (compat.TH_DECCTL_SET_TELEMETRY_BITS, 1),
    (compat.TH_DECCTL_SET_TELEMETRY_BITS, "x"),
    (0, None), (2, 5), (17, 1), (99, None),
])
def test_dec_ctl_codes_equal_jax(clip, req, buf):
    """Every TH_DECCTL_* code, with valid and invalid arguments: the same
    return code, or the same exception, and the same decoder state."""
    j, p = _ctx_pair(*clip)

    def run(ctx):
        try:
            return ("ret", ctx.ctl(req, buf))
        except Exception as e:  # the same exception type both ways
            return ("raised", type(e).__name__)

    assert run(p) == run(j)
    for attr in ("pp_level", "keyframe_num", "curframe_num", "telemetry",
                 "stripe_callback"):
        assert getattr(p._dec, attr) == getattr(j._dec, attr), attr
    assert (compat.TH_EBADPACKET, compat.TH_DUPFRAME, compat.TH_EVERSION) == (
        jax_compat.TH_EBADPACKET, jax_compat.TH_DUPFRAME,
        jax_compat.TH_EVERSION)


def _damaged_headers(pkts):
    info, comment, setup = (bytes(p.data) for p in pkts[:3])
    bumped = bytearray(info)
    bumped[7] += 1  # version major
    minor = bytearray(info)
    minor[8] += 1
    magic = bytearray(info)
    magic[3] ^= 0x20
    return {
        "in order": [(info, True), (comment, False), (setup, False)],
        "comment first": [(comment, False), (info, True)],
        "info without b_o_s": [(info, False), (info, True)],
        "version major": [(bytes(bumped), True), (info, True)],
        "version minor": [(bytes(minor), True)],
        "bad magic": [(bytes(magic), True), (info, True)],
        "short": [(b"\x80the", True), (b"\x80", True)],
        "data first": [(pkts[3].data, False), (info, True)],
        "data after info": [(info, True), (pkts[3].data, False)],
        "empty after info": [(info, True), (b"", False)],
        "info twice": [(info, True), (info, True)],
        "setup before comment": [(info, True), (setup, False),
                                 (comment, False)],
        "truncated setup": [(info, True), (comment, False),
                            (setup[:len(setup) // 3], False),
                            (setup, False)],
        "truncated comment": [(info, True), (comment[:9], False),
                              (comment, False)],
        "type 0x83": [(info, True), (b"\x83theora" + comment[7:], False)],
        "after setup": [(info, True), (comment, False), (setup, False),
                        (setup, False), (pkts[3].data, False)],
    }


def test_headerin_error_order_equals_jax(clip):
    pkts = clip[0]
    for label, seq in _damaged_headers(pkts).items():
        js, ps = {}, {}
        jr = [jax_compat.th_decode_headerin(js, JaxPacket(d, b_o_s=b))
              for d, b in seq]
        pr = [compat.th_decode_headerin(ps, Packet(d, b_o_s=b))
              for d, b in seq]
        assert pr == jr, label
        assert sorted(ps) == sorted(js), label
    assert compat.th_version_string() == jax_compat.th_version_string()
    for p in pkts[:5] + [Packet(b"")]:
        assert compat.th_packet_isheader(p.data) == \
            jax_compat.th_packet_isheader(p.data)
        assert compat.th_packet_iskeyframe(p.data) == \
            jax_compat.th_packet_iskeyframe(p.data)


def test_packetin_at_pp7_equals_jax(clip):
    """Headers in, alloc, pp 7, then every packet (a dup and a damaged one
    among them): the same return codes, granule positions and frames."""
    pkts = clip[0]
    js, ps = {}, {}
    for i, p in enumerate(pkts[:3]):
        assert compat.th_decode_headerin(ps, Packet(p.data, b_o_s=i == 0)) \
            == jax_compat.th_decode_headerin(js, JaxPacket(p.data,
                                                           b_o_s=i == 0))
    j = jax_compat.th_decode_alloc(js)
    p = compat.th_decode_alloc(ps, device="cpu")
    assert p.ctl(compat.TH_DECCTL_SET_PPLEVEL, 7) == 0 == \
        j.ctl(jax_compat.TH_DECCTL_SET_PPLEVEL, 7)
    datas = [q.data for q in pkts[3:]]
    datas = datas[:3] + [b"", bytes([0x00]) + b"\xff" * 50] + datas[3:]
    rets = []
    for d in datas + [b"\x00\x01"]:
        rets.append(p.packetin(d))
        assert rets[-1] == j.packetin(d)
        assert _frame_bytes(p.ycbcr_out()) == _frame_bytes(j.ycbcr_out())
    assert [r for r, _ in rets] == [0, 0, 0, compat.TH_DUPFRAME,
                                    compat.TH_EBADPACKET] + [0] * 6


def test_packetin_lets_a_kernel_failure_through(clip, monkeypatch):
    """Only a packet the host parse rejects is TH_EBADPACKET: an error of
    the device work (a kernel, its build) propagates."""
    from theora_tpu_torch.ops import postproc_cuda

    pkts, info, setup = clip
    p = compat.th_decode_alloc({"info": info, "setup": setup}, device="cpu")
    p.ctl(compat.TH_DECCTL_SET_PPLEVEL, 7)

    def broken(*args, **kwargs):
        raise RuntimeError("KP launch failed: CUDA error 700")

    monkeypatch.setattr(postproc_cuda, "postprocess_frames", broken)
    with pytest.raises(RuntimeError, match="CUDA error"):
        p.packetin(pkts[3].data)


def test_packetin_lets_a_wrapper_value_error_through(clip, monkeypatch):
    """A kernel wrapper's contract check raises ValueError on the device
    path; packetin lets it through rather than calling the packet bad."""
    from theora_tpu_torch.ops import postproc_cuda

    pkts, info, setup = clip
    p = compat.th_decode_alloc({"info": info, "setup": setup}, device="cpu")
    p.ctl(compat.TH_DECCTL_SET_PPLEVEL, 7)

    def rejects(*args, **kwargs):
        raise ValueError("srcs[0]: rows must be contiguous")

    monkeypatch.setattr(postproc_cuda, "postprocess_frames", rejects)
    with pytest.raises(ValueError, match="rows must be contiguous"):
        p.packetin(pkts[3].data)


def test_packetin_lets_a_stripe_callback_error_through(clip):
    """A ValueError of the user's stripe callback, raised after the frame
    decoded, propagates; a truncated packet is still TH_EBADPACKET."""
    pkts, info, setup = clip
    p = compat.th_decode_alloc({"info": info, "setup": setup}, device="cpu")

    def callback(*args):
        raise ValueError("callback failed")

    p.ctl(compat.TH_DECCTL_SET_STRIPE_CB, callback)
    with pytest.raises(ValueError, match="callback failed"):
        p.packetin(pkts[3].data)
    p.ctl(compat.TH_DECCTL_SET_STRIPE_CB, None)
    bad = bytes([0x00]) + b"\xff" * 50
    assert p.packetin(bad)[0] == compat.TH_EBADPACKET


# -------------------------------------------------------------------- CLI

def test_dec_cli_pp_and_telemetry_equal_jax(clip, tmp_path):
    """tools/dec.py --pp 7 --telemetry mbmode,mv (decode_clip on the CPU)
    writes the same .y4m bytes as the JAX package's CLI."""
    from theora_tpu.tools import dec as jax_dec
    from theora_tpu_torch.ogg import mux_stream
    from theora_tpu_torch.tools import dec

    pkts = clip[0]
    for i, p in enumerate(pkts):
        p.b_o_s = i == 0
        p.e_o_s = i == len(pkts) - 1
    ogv = tmp_path / "clip.ogv"
    ogv.write_bytes(mux_stream(pkts))
    a, b = tmp_path / "port.y4m", tmp_path / "jax.y4m"
    dec.main(["--pp", "7", "--telemetry", "mbmode,mv", "--device", "cpu",
              "--batch", "3", str(ogv), str(a)])
    jax_dec.main(["--pp", "7", "--telemetry", "mbmode,mv", str(ogv), str(b)])
    assert a.read_bytes() == b.read_bytes()
    plain = tmp_path / "plain.y4m"
    dec.main(["--device", "cpu", str(ogv), str(plain)])
    assert plain.read_bytes() != a.read_bytes()
