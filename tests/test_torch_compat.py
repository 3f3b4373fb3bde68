"""The `th_*` encode API and the pre-1.0 `theora_*` shim of the PyTorch
port (theora_tpu_torch.compat), with the host Encoder's frame dropping,
2-pass and VP3 compatibility under them, against the JAX package's
(theora_tpu.compat) on the CPU.

Each case of testdata/make_compat_enc.py runs through both packages
(device="cpu" on the port's side) and must give the same packets (bytes,
granulepos, packetno, b_o_s, e_o_s) and ctl return values, and the
record chip_smoke.py holds the card's packets to. The CBR case's closed
loop references after every frame equal the JAX embedded decoder's; the
VP3 stream decodes in the port's PacketDecoder to the JAX Decoder's
frames. Tolerance: none, every comparison is exact. F10 (JAX's rebuilt
Encoder forgets earlier ctls: the port keeps them) and F11 (the dup
count emits nothing, in both) each have a test."""
import hashlib
import importlib.util
import os

import numpy as np
import pytest
import torch

from tests.conftest import TESTDATA
from theora_tpu_torch import compat, tables
from theora_tpu_torch.info import TheoraInfo
from theora_tpu_torch.tpkt import Packet

# The tests run in several worker processes on a few CPUs: one torch
# thread each (their tensors are small, and idle intra-op threads spin).
torch.set_num_threads(1)

_spec = importlib.util.spec_from_file_location(
    "make_compat_enc", os.path.join(TESTDATA, "make_compat_enc.py"))
mc = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(mc)
CPU = {"device": "cpu"}


def _jax():
    from theora_tpu import compat as jcompat, tables as jtables
    from theora_tpu.info import TheoraInfo as JaxInfo
    from theora_tpu.tpkt import Packet as JaxPacket

    return jcompat, jtables, JaxInfo, JaxPacket


def _fields(pkts):
    return [(p.data, p.granulepos, p.packetno, bool(p.b_o_s), bool(p.e_o_s))
            for p in pkts]


def _record(name):
    return mc.mk.read_records("compat64x48_enc.sha256")[name]


@pytest.mark.parametrize("name", mc.CASES)
def test_case_equals_jax_and_the_record(name):
    """Every case packet for packet against the JAX package (with F10's
    settings set again on JAX's rebuilt Encoder) and against the record
    of compat64x48_enc.sha256: VBR with keyframe force and speed level 1;
    CBR at 8 kbit/s with 0-byte drops; drops off with a bitrate and a rate
    buffer changed mid-stream; VP3 with VP31's tables and its drop
    frames; VP31's quantization parameters; other Huffman codes; another
    encoder's setup header; the dup count (F11); the 2-pass ctl protocol
    (the last record is the pass-1 blob); the legacy API."""
    got = mc.run_case(name, compat, tables, TheoraInfo, Packet, **CPU)
    want = mc.run_case(name, *_jax(), jax=True)
    assert _fields(got) == _fields(want)
    assert mc.mk.record_of(got) == _record(name)


@pytest.mark.parametrize("name", list(mc.COMPAT_CASES))
def test_ctl_returns_equal_jax(name):
    """The ctl return values of each case: the keyframe frequency echoed,
    0 for the settings, TH_EINVAL for SET_QUALITY under a bitrate and for
    SET_COMPAT_CONFIG after the headers, GET_SPLEVEL."""
    jcompat, jtables, JaxInfo, _ = _jax()
    _, got = mc.run_compat(name, compat, tables, TheoraInfo, **CPU)
    _, want = mc.run_compat(name, jcompat, jtables, JaxInfo, jax=True)
    assert got == want
    assert got[-1] == compat.TH_EINVAL


def test_cases_reach_what_they_name():
    """cbr8k drops inter frames as 0-byte packets, the mid-stream case
    with drops off drops none, vp3_8k's drops are explicit inter frames
    that code no block (6 bytes at 64x48), its setup header carries VP31's
    tables, and dup_count emits one packet per frame."""
    def data(name):
        return [p.data for p in mc.run_case(name, compat, tables, TheoraInfo,
                                            Packet, **CPU)]

    cbr = data("cbr8k")[3:]
    assert b"" in cbr and cbr[0]
    assert all(data("cbr8k_nodrop_midstream")[3:])
    vp3 = data("vp3_8k")
    assert all(vp3[3:]) and sum(len(d) == 6 for d in vp3[3:]) >= 2
    assert all(d[0] & 0x40 for d in vp3[3:] if len(d) == 6)
    from theora_tpu_torch.headers import parse_setup_header

    assert parse_setup_header(vp3[2]).qinfo == tables.VP31_QUANT_INFO
    assert len(data("dup_count")) == 3 + 5


def test_cbr_closed_loop_references_equal_jax():
    """CBR at 8 kbit/s through th_enc_ctx: after every frame (dropped ones
    included) the port's closed-loop references, PREV and GOLD with their
    borders, equal the JAX Encoder's embedded decoder's."""
    from theora_tpu.constants import FRAME_GOLD, FRAME_PREV

    jcompat, _, JaxInfo, _ = _jax()
    kw = dict(frame_width=64, frame_height=48, pic_width=64, pic_height=48,
              quality=40, target_bitrate=8000)
    pctx = compat.th_encode_alloc(TheoraInfo(**kw), **CPU)
    jctx = jcompat.th_encode_alloc(JaxInfo(**kw))
    for c, ctx in ((compat, pctx), (jcompat, jctx)):
        ctx.ctl(c.TH_ENCCTL_SET_KEYFRAME_FREQUENCY_FORCE, 8)
        mc._headers(ctx)
    drops = 0
    for i, f in enumerate(mc.clip_frames(8)):
        pctx.ycbcr_in(f)
        jctx.ycbcr_in(f)
        got, want = pctx.packetout(False), jctx.packetout(False)
        assert got.data == want.data, i
        drops += got.data == b""
        prev, gold = pctx._enc._references()
        dec = jctx._enc._dec
        for pli in range(3):
            assert np.array_equal(
                prev[pli], dec.buffers[dec.ref_idx[FRAME_PREV]].planes[pli])
            assert np.array_equal(
                gold[pli], dec.buffers[dec.ref_idx[FRAME_GOLD]].planes[pli])
    assert drops >= 3


def test_vp3_stream_decodes_to_jax_frames():
    """The VP3 case's stream (drop frames included) through the port's
    PacketDecoder equals the JAX Decoder frame by frame."""
    from theora_tpu.decode.decoder import Decoder
    from theora_tpu.headers import parse_info_header as jinfo, \
        parse_setup_header as jsetup
    from theora_tpu_torch.decode.scalar import PacketDecoder
    from theora_tpu_torch.headers import parse_info_header, \
        parse_setup_header

    pkts = [p.data for p in mc.run_case("vp3_8k", compat, tables, TheoraInfo,
                                         Packet, **CPU)]
    pdec = PacketDecoder(parse_info_header(pkts[0]),
                         parse_setup_header(pkts[2]), device="cpu")
    jdec = Decoder(jinfo(pkts[0]), jsetup(pkts[2]))
    for d in pkts[3:]:
        assert pdec.decode_packet(d) == jdec.decode_packet(d)
        for a, b in zip(pdec.ycbcr_out(), jdec.ycbcr_out()):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("geom", [
    dict(frame_width=64, frame_height=48, pic_width=64, pic_height=48),
    dict(frame_width=64, frame_height=48, pic_width=64, pic_height=48,
         pixel_fmt=2),
    dict(frame_width=80, frame_height=64, pic_width=75, pic_height=60),
    dict(frame_width=2048, frame_height=2048, pic_width=2048,
         pic_height=2048),
])
def test_vp3_operating_restrictions_equal_jax(geom):
    """VP3 compatibility is refused (False echoed) for 4:2:2, a cropped
    picture and more than 4095 super blocks (2048x2048 luma alone has
    4096), granted for 64x48 4:2:0, as in JAX; a refusal keeps the
    default tables."""
    jcompat, _, JaxInfo, _ = _jax()
    ctx = compat.th_encode_alloc(TheoraInfo(quality=40, **geom), **CPU)
    got = ctx.ctl(compat.TH_ENCCTL_SET_VP3_COMPATIBLE, 1)
    want = jcompat.th_encode_alloc(JaxInfo(quality=40, **geom)).ctl(
        jcompat.TH_ENCCTL_SET_VP3_COMPATIBLE, 1)
    assert got is want
    assert ctx._enc.vp3_compatible is want
    assert (ctx._enc.qinfo is tables.VP31_QUANT_INFO) is want


def test_twopass_protocol_equals_jax():
    """TH_ENCCTL_2PASS_OUT / 2PASS_IN as encoder_example.c drives them: the
    38-byte placeholder, the 12-byte records, the summary, pass 1's
    packets, and pass 2 fed in 80-byte chunks, byte for byte."""
    jcompat, _, JaxInfo, _ = _jax()
    got = mc.run_twopass(compat, TheoraInfo, **CPU)
    want = mc.run_twopass(jcompat, JaxInfo)
    assert len(got[3]) == 38 and got[3] == want[3]
    assert got[1] == want[1] and len(got[1]) == 38 + 12 * 6
    assert _fields(got[2]) == _fields(want[2])
    assert _fields(got[0]) == _fields(want[0])


def test_legacy_round_trip_equals_jax():
    """The pre-1.0 API: theora_encode_* packets, theora_decode_* planes
    and theora_granule_time equal JAX's; the comment helpers too."""
    jcompat = _jax()[0]
    pkts, outs, t = mc.run_legacy(compat, **CPU)
    jpkts, jouts, jt = mc.run_legacy(jcompat)
    assert _fields(pkts) == _fields(jpkts)
    for a, b in zip(outs, jouts):
        for pa, pb in zip(a, b):
            assert np.array_equal(pa, pb)
    assert t == jt > 0
    for c in (compat, jcompat):
        tc = c.theora_comment()
        c.theora_comment_add_tag(tc, "ARTIST", "x")
        c.theora_comment_add(tc, "artist=y")
    assert compat.theora_comment_query(tc, "ARTIST", 1) == "y"
    assert compat.theora_comment_query_count(tc, "artist") == 2
    assert compat.theora_encode_comment(tc).data == \
        jcompat.theora_encode_comment(tc).data
    info = compat.theora_info(keyframe_frequency_force=100)
    assert compat.theora_granule_shift(info) == \
        jcompat.theora_granule_shift(jcompat.theora_info(
            keyframe_frequency_force=100)) == 7


@pytest.mark.parametrize("req,buf", [
    (compat.TH_ENCCTL_SET_QUANT_PARAMS, "vp31_quant"),
    (compat.TH_ENCCTL_SET_HUFFMAN_CODES, "rotated_huff"),
    (compat.TH_ENCCTL_SET_COMPAT_CONFIG, "setup_header"),
    (compat.TH_ENCCTL_SET_VP3_COMPATIBLE, 1),
])
def test_f10_rebuild_keeps_earlier_ctls(req, buf):
    """F10: JAX's ctl builds a new Encoder for these codes, which forgets
    the keyframe frequency (back to 64), the quality, the speed level
    (GET_SPLEVEL still answers the old one) and the rate controller with
    its flags. The port keeps them; its packets equal JAX's with those
    settings set again on JAX's side after the rebuild."""
    jcompat, jtables, JaxInfo, _ = _jax()
    kw = dict(frame_width=64, frame_height=48, pic_width=64, pic_height=48,
              quality=40, target_bitrate=20000)
    pctx = compat.th_encode_alloc(TheoraInfo(**kw), **CPU)
    jctx = jcompat.th_encode_alloc(JaxInfo(**kw))
    for c, ctx in ((compat, pctx), (jcompat, jctx)):
        ctx.ctl(c.TH_ENCCTL_SET_KEYFRAME_FREQUENCY_FORCE, 4)
        ctx.ctl(c.TH_ENCCTL_SET_SPLEVEL, 2)
        assert ctx.ctl(c.TH_ENCCTL_SET_RATE_FLAGS, 2) == 0
    pctx.ctl(req, mc._buf(tables, buf))
    jold = jctx._enc
    jctx.ctl(req, mc._buf(jtables, buf))
    jnew = jctx._enc
    # The fault: JAX's new Encoder forgot, its GET_SPLEVEL did not.
    assert (jnew.keyframe_freq, jnew.sp_level, jnew.rc) == (64, 0, None)
    assert jctx.ctl(jcompat.TH_ENCCTL_GET_SPLEVEL) == 2
    e = pctx._enc
    assert (e.keyframe_freq, e.sp_level, e.use_trellis) == (4, 2, False)
    assert e.rc is not None and not e.rc.drop_frames
    assert pctx.ctl(compat.TH_ENCCTL_GET_SPLEVEL) == 2
    jnew.keyframe_freq = jold.keyframe_freq
    jnew.set_splevel(jold.sp_level)
    jnew.rc = jold.rc
    got = mc._headers(pctx)
    want = mc._headers(jctx)
    for i, f in enumerate(mc.clip_frames(6)):
        for ctx, out in ((pctx, got), (jctx, want)):
            ctx.ycbcr_in(f)
            out.append(ctx.packetout(i == 5))
    assert _fields(got) == _fields(want)
    assert sum(not p.data[0] & 0x40 for p in got[3:] if p.data) == 2


def test_f11_dup_count_emits_nothing():
    """F11: TH_ENCCTL_SET_DUP_COUNT returns 0 and is never read, in JAX
    and here: the stream is the one without the ctl, one packet per
    frame."""
    jcompat, jtables, JaxInfo, _ = _jax()
    for c, t, I, kw in ((compat, tables, TheoraInfo, CPU),
                        (jcompat, jtables, JaxInfo, {})):
        ctx = c.th_encode_alloc(mc._info(I, quality=48), **kw)
        plain = c.th_encode_alloc(mc._info(I, quality=48), **kw)
        assert ctx.ctl(c.TH_ENCCTL_SET_DUP_COUNT, 3) == 0
        a, b = mc._headers(ctx), mc._headers(plain)
        for i, f in enumerate(mc.clip_frames(3)):
            for x, out in ((ctx, a), (plain, b)):
                x.ycbcr_in(f)
                out.append(x.packetout(i == 2))
                assert x.packetout(False) is None
        assert _fields(a) == _fields(b) and len(a) == 6


def test_rate_control_drops_caps_and_resize_equal_jax():
    """RateControl frame by frame against JAX's: drops of inter frames
    that bust the budget (the return value), each rate flag, a buffer resize and a bitrate change mid-stream, and
    select_qi's frames_since_kf."""
    from theora_tpu.encode import rate as jrate
    from theora_tpu.info import TheoraInfo as JaxInfo
    from theora_tpu_torch.encode import rate

    kw = dict(frame_width=64, frame_height=48, pic_width=64, pic_height=48,
              quality=10, target_bitrate=30000)
    rng = np.random.default_rng(23)
    bits = rng.lognormal(10.5, 0.9, 48).astype(np.int64)
    for flags in (1, 3, 5, 0):
        ours = rate.RateControl(TheoraInfo(**kw), 6)
        ref = jrate.RateControl(JaxInfo(**kw), None, 6)
        for rc in (ours, ref):
            rc.set_rate_flags(flags)
        qa = qb = None
        drops = 0
        for i, b in enumerate(bits):
            ft = 0 if i % 6 == 0 else 1
            if i == 20:
                ours.resize_buffer(30)
                ref.resize_buffer(30)
            if i == 30:
                ours.set_bitrate(60000)
                ref.set_bitrate(60000)
            qa = ours.select_qi(ft, qa, frames_since_kf=i % 6)
            qb = ref.select_qi(ft, qb, frames_since_kf=i % 6)
            assert qa == qb, (flags, i)
            args = (ft, qa, int(b))
            da = ours.update(*args, droppable=ft == 1)
            db = ref.update(*args, droppable=ft == 1)
            assert da == db, (flags, i)
            drops += da
            assert (ours.fullness, ours.rate_bias, ours.log_scale,
                    ours.prev_drop_count, ours.ndrops) == \
                (ref.fullness, ref.rate_bias, ref.log_scale,
                 ref.prev_drop_count, ref.ndrops), (flags, i)
        assert (drops > 0) == bool(flags & 1), flags


@pytest.mark.parametrize("case", list(mc.CLI_CASES))
def test_enc_cli_host_equals_jax_cli(tmp_path, case):
    """`tools/enc.py --host` (the host Encoder, closed loop on the CPU) at
    -b with drops, --drop-frames 0 and --two-pass --rate-buffer 12 (with
    --two-pass-file) byte for byte against the JAX CLI's default branch,
    and against compat_cli.sha256."""
    from theora_tpu.tools import enc as jenc
    from theora_tpu_torch.tools import enc
    from theora_tpu_torch.tools.y4m import write_y4m

    y4m = str(tmp_path / "in.y4m")
    write_y4m(y4m, mc.cli_frames())
    flags = mc.CLI_CASES[case]
    extra = ["--two-pass-file", str(tmp_path / "p.ot2p")] \
        if "--two-pass" in flags else []
    enc.main(["--host", "--device", "cpu", *flags, *extra, y4m,
              str(tmp_path / "port.ogv")])
    jenc.main([*flags, y4m, str(tmp_path / "jax.ogv")])
    got = (tmp_path / "port.ogv").read_bytes()
    assert got == (tmp_path / "jax.ogv").read_bytes()
    assert hashlib.sha256(got).hexdigest() == mc.mk.read_cli(
        "compat_cli.sha256")[case]
    if extra:
        assert (tmp_path / "p.ot2p").read_bytes()[:4] == b"OT2P"


def test_enc_cli_drop_frames_needs_host(tmp_path):
    """The device encoders never drop: --drop-frames without --host is a
    usage error (JAX's --device ignores it)."""
    from theora_tpu_torch.tools import enc

    with pytest.raises(SystemExit) as e:
        enc.main(["-b", "20000", "--drop-frames", "0", "--device", "cpu",
                  str(tmp_path / "in.y4m"), str(tmp_path / "out.ogv")])
    assert e.value.code == 2


def test_entry_points_without_card_raise(monkeypatch):
    """th_encode_alloc, theora_encode_init and theora_decode_init default
    to the card; without one they raise and never carry on on the CPU."""
    pkts = mc.run_case("legacy", compat, tables, TheoraInfo, Packet, **CPU)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compat.th_encode_alloc(mc._info(TheoraInfo, quality=40))
    ci = compat.theora_info(width=64, height=48, frame_width=64,
                            frame_height=48)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compat.theora_encode_init(compat.theora_state(), ci)
    di = compat.theora_info()
    for h in pkts[:3]:
        assert compat.theora_decode_header(di, None, h) == 0
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compat.theora_decode_init(compat.theora_state(), di)
    assert compat.th_encode_alloc(mc._info(TheoraInfo, quality=40),
                                  **CPU)._enc.device.type == "cpu"
