"""Adaptive quantization in the PyTorch port against the JAX package, on
the CPU, exact (tolerance 0 throughout): the host gates (qi triple, luma
activity, mixed-frame and noise gates, activity scales), the block-qi
packing, kernel K2's and KT's plain versions at K qi rows with per-block
lambda scales, and whole encodes with `GopEncoder(device="cpu")` at its
default adaptive_quant="auto" (and True) against the JAX
`TpuGopEncoder`, packets byte for byte (the JAX encodes as the committed
record testdata/aq_cases.pkts); the encoder CLI at default flags (the
JAX CLI's output as its SHA-256, testdata/cli_cases.sha256);
rd_strength."""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import TESTDATA
from tests.test_torch_encode_ops import jax_scan_trellis
from theora_tpu.ops import transforms_jax as tj
from theora_tpu_torch import tables
from theora_tpu_torch.encode import aq
from theora_tpu_torch.encode.gop import trellis_bit_costs
from theora_tpu_torch.ops import fdct_cuda, trellis_cuda
from theora_tpu_torch.quant import dequant_tables_init

_spec = importlib.util.spec_from_file_location(
    "make_hd720_enc", os.path.join(TESTDATA, "make_hd720_enc.py"))
make_enc = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(make_enc)

DQ = dequant_tables_init(tables.DEF_QUANT_INFO)
MODES = (False, True, "auto")
# (noise-like, mixed with lambda scales): neither, noise-like, mixed.
GATES = ((False, False), (True, False), (False, True))


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs in several worker processes on shared cores; these
    small tensors gain nothing from many intra-op threads."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


def _info(mod, w, h, qi, fmt=0):
    return mod.TheoraInfo(frame_width=w, frame_height=h, pic_width=w,
                          pic_height=h, quality=qi, pixel_fmt=fmt)


# ------------------------------------------------------------ host gates

@pytest.mark.parametrize("fmt", [0, 2, 3])
def test_qi_triple_equals_jax(fmt):
    """The qi list for every qi, both frame types, the three modes and
    the three gate states, against Encoder._adaptive_qi_triple (its
    find_qi tie rule included) and TpuGopEncoder._adaptive_qis."""
    from theora_tpu import info as jinfo
    from theora_tpu.encode.encoder import Encoder
    from theora_tpu.encode.tpu_gop import TpuGopEncoder

    enc = Encoder(_info(jinfo, 64, 48, 40, fmt))
    tenc = TpuGopEncoder(_info(jinfo, 64, 48, 40, fmt), qi=40)
    engaged = set()
    for mode in MODES:
        for noise, mixed in GATES:
            enc.adaptive_quant = tenc.adaptive_quant = mode
            tenc.enc._frame_noise_like = enc._frame_noise_like = noise
            tenc.enc._frame_mixed = enc._frame_mixed = mixed
            tenc.enc._frag_lam_scale = enc._frag_lam_scale = (
                np.ones(4) if mixed else None)
            for qi in range(64):
                enc.qi = qi
                tenc.qi = qi
                for qti in (0, 1):
                    want = enc._adaptive_qi_triple(qti)
                    got = aq.qi_triple(mode, qi, qti, fmt, noise, mixed,
                                       mixed)
                    assert got == want, (mode, noise, mixed, qi, qti)
                    if want:
                        engaged.add((mode, noise, mixed, len(want)))
                    assert aq.frame_qis(
                        mode, qi, fmt, qti == 0, noise, mixed, mixed) == \
                        tenc._adaptive_qis(keyframe_only=qti == 0)
    # Every mode that can engage did, with pairs and triples.
    assert {(m, n) for m, n, _, _ in engaged} >= {(True, False),
                                                  ("auto", False),
                                                  ("auto", True)}
    assert {k for *_, k in engaged} == {2, 3}


def _planes():
    """Seeded luma planes: iid noise, a smooth ramp, the half-smooth,
    half-noise frame, a flat plane, a texture, a small mover on a flat
    field."""
    rng = np.random.default_rng(31)
    h, w = 64, 96
    yy, xx = np.indices((h, w))
    mover = np.full((h, w), 40, np.uint8)
    mover[20:28, 30:46] = rng.integers(0, 256, (8, 16))
    return {
        "noise": rng.integers(0, 256, (h, w)).astype(np.uint8),
        "ramp": ((xx * 2 + yy) % 256).astype(np.uint8),
        "halfmix": make_enc.mixed_frames()[0][0],
        "flat": np.full((h, w), 77, np.uint8),
        "texture": (128 + 60 * np.sin(xx / 2.0) * np.cos(yy / 3.0)).astype(
            np.uint8),
        "mover": mover,
    }


@pytest.mark.parametrize("name", ["noise", "ramp", "halfmix", "flat",
                                  "texture", "mover"])
def test_gates_equal_jax(name):
    """Luma activity (against the JAX package's native
    activity8_plane_native and Encoder._luma_activity), the mixed-frame
    gate, the activity scales (float64, and their float32 cast, which the
    encoder uses) and the noise gate."""
    from theora_tpu import info as jinfo
    from theora_tpu.encode.encoder import Encoder
    from theora_tpu.native import activity8_plane_native

    y = _planes()[name]
    act = aq.luma_activity(y)
    assert np.array_equal(act, activity8_plane_native(y))
    assert np.array_equal(act, Encoder._luma_activity(y))
    assert aq.mixed_frame(act) == Encoder._mixed_frame(act)
    with np.errstate(invalid="ignore"):  # 0 / 0 on the flat plane
        want = Encoder(_info(jinfo, 96, 64, 40))._activity_iscale(act)
        got = aq.activity_iscale(act)
    assert got.dtype == want.dtype == np.float64
    # A flat plane's activities are all 0: both sides divide 0 by 0 (no
    # scale is used there: the frame is not mixed).
    assert np.array_equal(got, want, equal_nan=True)
    assert np.array_equal(got.astype(np.float32), want.astype(np.float32),
                          equal_nan=True)
    assert aq.noise_like(y) == Encoder._noise_like(y)
    nl, mixed, sc = aq.frame_gates(y, "auto")
    assert (nl, mixed) == (Encoder._noise_like(y), Encoder._mixed_frame(act))
    assert (sc is None) == (not mixed or nl)
    assert aq.frame_gates(y, False)[2] is None


def test_gate_planes_cover_each_gate():
    """The seeded planes of test_gates_equal_jax reach both outcomes of
    each gate."""
    planes = _planes()
    assert aq.noise_like(planes["noise"])
    assert not aq.noise_like(planes["ramp"])
    assert not aq.noise_like(planes["flat"])
    assert aq.mixed_frame(aq.luma_activity(planes["halfmix"]))
    assert not aq.mixed_frame(aq.luma_activity(planes["noise"]))


# ---------------------------------------------------------- block qi RLE

@pytest.mark.parametrize("w,h,nqis", [(64, 48, 2), (64, 48, 3),
                                      (96, 64, 3), (640, 480, 2),
                                      (640, 480, 3)])
def test_block_qis_pack_equals_jax(w, h, nqis):
    """The frame header with its qis and the block-qi RLE over the coded
    blocks in coded order, against Encoder._frame_header_pack and
    _block_qis_pack, bit for bit: random plans, no block at a non-base
    qi, every block at one, no coded block, and at 640x480 runs longer
    than 4,129 blocks (the long-run escape)."""
    from theora_tpu import info as jinfo
    from theora_tpu.bitio import BitWriter as JBitWriter
    from theora_tpu.encode.encoder import Encoder
    from theora_tpu_torch.bitio import BitWriter
    from theora_tpu_torch.encode.packer import FramePacker
    from theora_tpu_torch.info import TheoraInfo

    enc = Encoder(_info(jinfo, w, h, 40))
    pk = FramePacker(TheoraInfo(frame_width=w, frame_height=h, pic_width=w,
                                pic_height=h, quality=40))
    nf = pk.geometry.nfrags
    rng = np.random.default_rng(w + nqis)
    qis = [40, 30, 50][:nqis]
    plans = [(rng.random(nf) < p, rng.integers(0, nqis, nf))
             for p in (0.3, 0.9)]
    plans += [(np.ones(nf, bool), np.zeros(nf, np.int64)),
              (np.ones(nf, bool), np.full(nf, nqis - 1)),
              (np.ones(nf, bool), 1 + (np.arange(nf) // 5000) % (nqis - 1)),
              (np.zeros(nf, bool), rng.integers(0, nqis, nf))]
    for coded, qii in plans:
        for ftype in (0, 1):
            a, b = JBitWriter(), BitWriter()
            enc._frame_qis = qis
            enc._frame_header_pack(a, ftype, qis)
            enc._block_qis_pack(a, qii.astype(np.int32), coded)
            pk._frame_header_pack(b, ftype, qis)
            pk._block_qis_pack(b, qis, qii.astype(np.int32), coded)
            assert (b.bytes(), b.bitpos) == (a.bytes(), a.bitpos)
    for n in (1, 2, 3):
        a, b = JBitWriter(), BitWriter()
        enc._frame_header_pack(a, 1, [40, 30, 50][:n])
        pk._frame_header_pack(b, 1, [40, 30, 50][:n])
        assert (b.bytes(), b.bitpos) == (a.bytes(), a.bitpos)


# ------------------------------------------------ K2 and KT at K qi rows

def _row_inputs(seed, n, qis, pli):
    """Random residual blocks, inter flags and the [K, 2, 64] dequant rows
    of qis with every row's DC at qis[0]."""
    rng = np.random.default_rng(seed)
    res = rng.integers(-255, 256, (n, 64)) // rng.integers(1, 40, (n, 1))
    deq = DQ[list(qis), pli].astype(np.int16)
    deq[:, :, 0] = deq[:1, :, 0]
    return (rng, res.astype(np.int16), deq,
            rng.integers(0, 2, n).astype(np.uint8))


def test_k2_rows_equal_jax_fdct_and_quantize():
    """K2's plain version at K = 3 (the q56 inter triple) against
    tj.fdct8x8 + tj.quantize, row by row."""
    _, res, deq, inter = _row_inputs(41, 3000, (56, 46, 63), 0)
    q, d = fdct_cuda.fdct_quantize(_t(res), _t(deq), _t(inter))
    assert q.shape == (3, 3000, 64)
    dct = np.asarray(tj.fdct8x8(jnp.asarray(
        res.reshape(-1, 8, 8).astype(np.int32))))
    assert np.array_equal(d.numpy(), dct)
    for k in range(3):
        rows = deq[k].astype(np.int32)[inter]
        want = np.asarray(tj.quantize(jnp.asarray(dct), jnp.asarray(rows)))
        assert np.array_equal(q[k].numpy(), want), k
        # DC quantizes with the base qi in every row.
        assert np.array_equal(q[k].numpy()[:, 0], q[0].numpy()[:, 0])


@pytest.mark.parametrize("scaled", [False, True])
def test_kt_rows_equal_jax_trellis(scaled):
    """KT's plain version at K = 3 on K2's outputs, an inter frame's
    lambdas per row, with per-block lambda scales in [0.1, 8] (the float32
    product lam[k] * lam_sc[n], tpu_gop.py:228) or without, against
    tj.trellis_values in the encoder's scan, row by row: values, nonzero
    counts, DC-only flags. With the scales the lambdas are fractional, so
    the placement of XLA's fused multiply-adds in the costs decides some
    blocks."""
    qis = (56, 46, 63)
    rng, res, deq, inter = _row_inputs(43, 3000, qis, 0)
    q, d = fdct_cuda.fdct_quantize(_t(res), _t(deq), _t(inter))
    lam = np.array([tables.RD_LAMBDA[0][1][x] for x in qis], np.float32)
    sc = rng.uniform(0.1, 8.0, 3000).astype(np.float32) if scaled else None
    nb = trellis_bit_costs(tables.VP31_HUFF_CODES)
    vals, cnt, dc_only = trellis_cuda.trellis_quantize(
        q, d, _t(deq), _t(inter), _t(lam), torch.from_numpy(nb),
        None if sc is None else _t(sc))
    dct = d.numpy().astype(np.int32)
    acmin = np.where(inter == 0, 3, 0).astype(np.int32)
    ones = np.ones(3000, np.float32)
    for k in range(3):
        ref = np.asarray(jax_scan_trellis(
            dct, q[k].numpy().astype(np.int32),
            deq[k].astype(np.int32)[inter], np.full(3000, lam[k], np.float32),
            ones if sc is None else sc, nb, acmin))
        assert np.array_equal(vals[k].numpy(), ref), k
        nz = ref != 0
        assert np.array_equal(cnt[k].numpy(), nz.sum(1))
        assert np.array_equal(dc_only[k].numpy(), ~nz[:, 1:].any(1))


# ---------------------------------------------------------- whole encodes

# name -> (frames, w, h, qi, keyframe_freq, mode, K the gates must reach):
# the generator's cases, whose JAX encodes are the committed record
# testdata/aq_cases.pkts (testdata/make_hd720_enc.py).
GATE_ROWS = {"auto_q56_moving": 3, "true_q40_mixed": 3, "auto_q24_noise": 3,
             "auto_q36_smooth": 1, "auto_q48_halftexture": 3}
CASES = {name: (frames(), w, h, qi, kf, mode, GATE_ROWS[name])
         for name, (frames, w, h, qi, kf, mode)
         in make_enc.AQ_CASES.items()}
# The cases with a committed list, which chip_smoke.py holds the card to.
LISTS = {"true_q40_mixed": "mixed96x64_q40_aq_enc.sha256",
         "auto_q48_halftexture": "halftex96x64_q48_aq_enc.sha256"}


def _jax_records():
    """The JAX encodes of CASES and of the rd_strength cases:
    {case: [(SHA-256, granulepos, packetno, b_o_s, e_o_s)]}."""
    return make_enc.read_records("aq_cases.pkts")


def _port(frames, w, h, qi, kf, mode, **kw):
    from theora_tpu_torch import info
    from theora_tpu_torch.encode.gop import GopEncoder

    enc = GopEncoder(_info(info, w, h, qi), qi=qi, device="cpu",
                     adaptive_quant=mode, **kw)
    return enc, enc.encode_clip(frames, keyframe_freq=kf, clip_batch=8)


@pytest.mark.parametrize("name", list(CASES))
def test_encode_packets_equal_jax(name):
    """GopEncoder at adaptive_quant "auto" (its default) or True against
    TpuGopEncoder, every packet: the q56 triple on every frame (the
    one-frame last GOP takes the intra triple); the half-smooth,
    half-noise 96x64 clip at True, which must code blocks at a non-base
    qi (its frames are mixed but noise-like, so no lambda scales); the
    noise gate at q24; q36 on smooth frames, where no gate engages and
    the bytes equal adaptive_quant=False's; and the half-smooth,
    half-texture clip at q48, whose mixed frames engage the triple with
    per-block lambda scales in the trellis and the chooser."""
    import hashlib

    frames, w, h, qi, kf, mode, k = CASES[name]
    enc, got = _port(frames, w, h, qi, kf, mode)
    want = _jax_records()[name]
    assert len(got) == len(want) == 3 + len(frames)
    for i, (a, b) in enumerate(zip(make_enc.record_of(got), want)):
        assert a[:3] == b[:3], f"packet {i}"
    planes = [np.ascontiguousarray(fr[0][::-1]) for fr in frames]
    lens = {len(aq.frame_qis(mode, qi, 0, False,
                             *_gate_args(y, mode))) for y in planes}
    assert max(lens) == k
    if name in LISTS:
        assert enc.nonbase_qi_blocks > 0
        with open(os.path.join(TESTDATA, LISTS[name])) as f:
            assert [hashlib.sha256(p.data).hexdigest() for p in got] == \
                f.read().split()
    if name in ("true_q40_mixed", "auto_q24_noise"):
        assert all(aq.noise_like(y) for y in planes)
    if name == "auto_q48_halftexture":
        assert all(aq.frame_gates(y, mode)[2] is not None for y in planes)
    if name == "auto_q36_smooth":
        assert enc.nonbase_qi_blocks == 0
        assert [p.data for p in _port(frames, w, h, qi, kf, False)[1]] == \
            [p.data for p in got]


def _gate_args(y, mode):
    nl, mixed, sc = aq.frame_gates(y, mode)
    return nl, mixed, sc is not None


@pytest.mark.parametrize("name", ["true_q40_mixed", "auto_q48_halftexture"])
def test_closed_loop_equals_port_decoder(name):
    """With the qi triple (and, on the half-texture clip, the activity
    scales), the reconstruction the encode carries equals the port's
    BatchDecoder on its packets."""
    from theora_tpu_torch.decode.batch import BatchDecoder
    from theora_tpu_torch.encode.gop import GopEncoder
    from theora_tpu_torch.headers import parse_info_header, \
        parse_setup_header
    from theora_tpu_torch.info import TheoraInfo

    frames, w, h, qi, _, mode, _ = CASES[name]
    enc = GopEncoder(TheoraInfo(frame_width=w, frame_height=h, pic_width=w,
                                pic_height=h, quality=qi), qi=qi,
                     device="cpu", adaptive_quant=mode)
    datas, recon = enc.encode_gop(frames, want_recon=True)
    assert enc.nonbase_qi_blocks > 0
    hdr = enc.flush_headers()
    outs = BatchDecoder(parse_info_header(hdr[0].data),
                        parse_setup_header(hdr[2].data),
                        device="cpu").decode_clip(datas, batch=4)
    g = enc.g
    for f, out in enumerate(outs):
        for pli in range(3):
            vpad, hpad = g.plane_padding(pli)
            ph, pw = g.plane_shape(pli)
            assert np.array_equal(
                recon[pli][f][vpad:vpad + ph, hpad:hpad + pw][::-1],
                out[pli]), (f, pli)


@pytest.mark.parametrize("rd", [3.0, 1.5])
def test_rd_strength_equals_jax(rd):
    """rd_strength as a constructor argument: the half-texture clip (the
    triple with lambda scales) at the default 3.0 and at 1.5, against
    TpuGopEncoder with the same rd_strength (the record's "rd3.0" and
    "rd1.5" cases); 1.5 changes the bytes."""
    assert rd in make_enc.RD_STRENGTHS
    frames, w, h, qi, kf, mode, _ = CASES["auto_q48_halftexture"]
    _, got = _port(frames, w, h, qi, kf, mode, rd_strength=rd)
    want = _jax_records()[f"rd{rd}"]
    assert [r[0] for r in make_enc.record_of(got)] == [r[0] for r in want]
    if rd != 3.0:
        _, base = _port(frames, w, h, qi, kf, mode)
        assert [p.data for p in base] != [p.data for p in got]


def test_encoder_cli_default_flags_equal_jax_cli(tmp_path):
    """python -m theora_tpu_torch.tools.enc --device cpu at its default
    flags (q48, keyframes every 64, adaptive quantization "auto") writes
    the JAX CLI's device-tier .ogv (its SHA-256, the committed
    testdata/cli_cases.sha256), for the noise clip cropped to 60x44
    (edge-padded frame, crop rectangle), where the noise gate engages the
    triple; with adaptive quantization off the bytes differ."""
    import hashlib

    from theora_tpu_torch.tools import enc as tenc
    from theora_tpu_torch.tools.y4m import write_y4m

    name = "noise60x44_defaults"
    frames, flags = make_enc.CLI_CASES[name]
    assert flags == []
    y4m = str(tmp_path / "in.y4m")
    write_y4m(y4m, frames())
    b, off = str(tmp_path / "port.ogv"), str(tmp_path / "off.ogv")
    tenc.main(["--device", "cpu", y4m, b])
    tenc.main(["--device", "cpu", "--adaptive-quant", "off", y4m, off])
    with open(b, "rb") as fb, open(off, "rb") as fo:
        port = fb.read()
        assert hashlib.sha256(port).hexdigest() == make_enc.read_cli()[name]
        assert fo.read() != port
