"""The PyTorch port's speed levels and scene-cut keyframes against the JAX
package: the R/D quantizer (transforms.quantize_rd and kernel KR's
wrapper on the CPU, qrd_cuda.quantize_rd) against
transforms_jax.quantize_rd, including the blocks where the placement of
XLA's fused multiply-adds decides; the mode decision without motion
compensation; detect_scene_cuts; and GopEncoder(device="cpu") at speed
levels 2 and 4, with use_trellis=False at three qi rows and with
auto_keyframe, against the packet lists the JAX TpuGopEncoder made
(testdata/make_hd720_enc.py). Exact equality everywhere."""
import hashlib
import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

from tests.conftest import TESTDATA
from theora_tpu.ops import transforms_jax as tj
from theora_tpu_torch import tables
from theora_tpu_torch.ops import fdct_cuda, qrd_cuda, transforms
from theora_tpu_torch.quant import dequant_tables_init
from theora_tpu_torch.tools import bench_fdct, bench_qrd

# The tests run in several worker processes on a few CPUs: one torch
# thread each (their tensors are small, and idle intra-op threads spin).
torch.set_num_threads(1)


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(TESTDATA, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


make_enc = _load("make_hd720_enc")
make_fma = _load("make_qrd_fma_cases")
DQ = dequant_tables_init(tables.DEF_QUANT_INFO)
FMA_CASES = os.path.join(TESTDATA, "vectors", "qrd_fma_cases.npz")


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs in several worker processes on shared cores; these
    small tensors gain nothing from many intra-op threads."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


_jax_qrd = jax.jit(tj.quantize_rd)


def _jax_rows(args):
    """JAX quantize_rd at each qi row of KR arguments: per row the block's
    dequant row and lambda by its own type (intra or inter). Returns the
    [K, N, 64] values, [K, N] counts and DC-only flags."""
    qout, dout, deq, inter, lam_q = args
    sel = inter.numpy().astype(np.int64)
    vals = np.stack([
        np.asarray(_jax_qrd(dout.numpy().astype(np.int32),
                            deq[k].numpy().astype(np.int32)[sel],
                            lam_q[k].numpy()[sel]))
        for k in range(qout.shape[0])])
    nz = vals != 0
    cnt = nz.sum(axis=2)
    return vals, cnt, cnt - nz[:, :, 0] == 0


def _assert_kr_equals_jax(args):
    vals, cnt, dc_only = qrd_cuda.quantize_rd(*args)
    want = _jax_rows(args)
    assert np.array_equal(vals.numpy(), want[0])
    assert np.array_equal(cnt.numpy(), want[1])
    assert np.array_equal(dc_only.numpy(), want[2])
    return want[0]


# ------------------------------------------------------------ kernel KR

@pytest.mark.parametrize("pli,qis,blocks", [
    (0, [20, 40, 63], "mixed"), (1, [20, 40, 63], "mixed"),
    (2, [56, 46, 63], "intra"), (2, [56, 46, 63], "inter"),
])
def test_kr_rows_equal_jax_on_k2_outputs(pli, qis, blocks):
    """KR's wrapper (the plain version on the CPU) against JAX
    quantize_rd row by row on K2's outputs for 2,000 seeded random
    residuals at three qi rows of one call, each row's DC at its first
    qi as the encoder builds them (bench_fdct.triple_rows), with the
    plane's R/D lambdas: luma and chroma with intra and inter blocks
    mixed (each block takes its own type's lambda), and the q56 triple
    with every block intra, then inter. The quantizer must move some
    values off round-to-nearest at every row."""
    rng = np.random.default_rng(30 + pli)
    n = 2000
    inter = {"mixed": rng.integers(0, 2, n), "intra": np.zeros(n),
             "inter": np.ones(n)}[blocks].astype(np.uint8)
    deq = torch.from_numpy(bench_fdct.triple_rows(qis, pli))
    q, d = fdct_cuda.fdct_quantize(
        torch.from_numpy(bench_fdct.random_residuals(rng, n)), deq,
        torch.from_numpy(inter))
    args = (q, d, deq, torch.from_numpy(inter),
            torch.from_numpy(bench_qrd.lam_q_rows(qis, pli)))
    vals = _assert_kr_equals_jax(args)
    moved = (vals != q.numpy()).any(axis=2).sum(axis=1)
    assert (moved > 0).all()


def test_kr_edge_classes_equal_jax():
    """The edge classes (a lone +-1 at position 1 and at position 63, +-1
    pairs, blocks with no nonzero AC value, +-32767) among fDCTs of
    random residuals, intra and inter blocks mixed, at q40."""
    args = bench_qrd.edge_args("cpu")
    vals = _assert_kr_equals_jax(args)
    q0 = args[0].numpy()[0]
    k = np.arange(0, 600, 6)
    # Lone +-1s at position 1 and 63 are killed or kept, never moved.
    for j, pos in enumerate((1, 63)):
        assert (np.abs(q0[k + j, pos]) == 1).any()
        v = vals[0, k + j, pos]
        assert ((v == 0) | (v == q0[k + j, pos])).all()
        assert (vals[0, k + j, pos] == 0).any()
    assert (vals[0, k + 3, 1:] == 0).all()


def test_plain_quantize_rd_equals_jax_on_int16_range():
    """The plain function on random coefficients over the int16 range
    and on fDCTs of random residuals, random qi, plane and frame type,
    lambdas over a wide range."""
    rng = np.random.default_rng(31)
    n = 4000
    res = (rng.integers(-255, 256, (n, 8, 8))
           // rng.integers(1, 40, (n, 1, 1)))
    dct = transforms.fdct8x8(torch.from_numpy(res.astype(np.int32))).numpy()
    dct[: n // 4] = rng.integers(-32768, 32768, (n // 4, 64))
    qi = rng.integers(0, 64, n)
    deq = DQ[qi, rng.integers(0, 3, n), rng.integers(0, 2, n)].astype(
        np.int32)
    lam = (transforms.rd_lambda(0, 1) * deq[:, 1].astype(np.float64) ** 2
           * rng.uniform(0.1, 10.0, n)).astype(np.float32)
    want = np.asarray(_jax_qrd(dct, deq, lam))
    got = transforms.quantize_rd(torch.from_numpy(dct),
                                 torch.from_numpy(deq),
                                 torch.from_numpy(lam)).numpy()
    assert np.array_equal(got, want)


def test_quantize_rd_fma_hazard():
    """Hazard: XLA's CPU compiler fuses the R/D quantizer's magnitude
    test err + lam * bits as fma(lam, bits, err) on both sides and the
    kill sweeps' gain av * av - err_coded as fma(av, av, -err_coded). On
    the blocks of testdata/vectors/qrd_fma_cases.npz (lambdas within a
    few ulps of a tie; testdata/make_qrd_fma_cases.py) the port equals
    JAX, the plain function and KR's wrapper alike, and each other way
    of forming one of those expressions fails on some."""
    cases = np.load(FMA_CASES)
    dct = cases["dct"].astype(np.int32)
    deq = cases["deq"].astype(np.int32)
    lam = cases["lam"]
    assert len(dct) >= 100 and lam.dtype == np.float32
    want = np.asarray(_jax_qrd(dct, deq, lam))
    args = [torch.from_numpy(a) for a in (dct, deq, lam)]
    assert np.array_equal(transforms.quantize_rd(*args).numpy(), want)
    for i, kargs in enumerate(bench_qrd.fma_args(FMA_CASES, "cpu")):
        assert np.array_equal(qrd_cuda.quantize_rd(*kargs)[0][0, 0].numpy(),
                              want[i]), i
    q0 = transforms.quantize(args[0], args[1])
    for what, alt in make_fma.ALTERNATES.items():
        other = make_fma.variant(*alt)(q0, *args).numpy()
        assert not np.array_equal(other, want), what


# ---------------------------------------------------- speed level 4's ME

def test_mode_decision_without_motion_compensation_equals_jax():
    """mode_decide_native with no_mc (speed level 4) against the JAX
    package's native twin on random SADs and vectors: the MV and golden
    MV vectors count as zero and 4MV is never chosen; without no_mc the
    two still agree."""
    from theora_tpu.native import mode_decide_native as jax_decide
    from theora_tpu_torch.constants import MODE_INTER_MV_FOUR
    from theora_tpu_torch.native import mode_decide_native

    rng = np.random.default_rng(33)
    nv, nh, k = 3, 4, 16
    n = nv * nh
    mb_list = np.arange(n)
    rc = np.indices((nv, nh)).reshape(2, -1)
    birc = np.stack([np.stack([2 * rc[0] + a, 2 * rc[1] + b], -1)
                     for a in (0, 1) for b in (0, 1)], 1)
    all4 = np.ones(n, bool)

    def sads(*shape):
        return rng.integers(0, 3000, shape).astype(np.int32)

    for no_mc in (True, False):
        for _ in range(4):
            cands = rng.integers(-6, 7, (k, 2)).astype(np.int32)
            ins = (rng.integers(-8, 9, (nv, nh, 2)), sads(nv, nh),
                   sads(nv, nh), sads(nv, nh), sads(nv, nh), cands,
                   sads(k, nv, nh), rng.integers(-8, 9, (nv, nh, 2)),
                   sads(nv, nh), rng.integers(-8, 9, (2 * nv, 2 * nh, 2)),
                   sads(nv, nh) // 2)
            args = (mb_list, rc[0], rc[1], all4, birc) + ins + (n, 0.7,
                                                               190.0)
            got = mode_decide_native(*args, no_mc)
            want = jax_decide(*args, no_mc)
            for g, w in zip(got, want):
                assert np.array_equal(g, w)
            if no_mc:
                assert not (got[0] == MODE_INTER_MV_FOUR).any()


# ---------------------------------------------------------- scene cuts

def test_detect_scene_cuts_equals_jax():
    """detect_scene_cuts and gop_starts of the port against the JAX
    package's on the clip with a cut at frame 9 (the only cut it holds),
    at keyframe spacings 8 and 4, and on noise, where every frame is a
    cut."""
    from theora_tpu.encode import tpu_gop
    from theora_tpu_torch.encode import gop

    cut = make_enc.cut_frames()
    assert gop.detect_scene_cuts(cut, 8) == [0, 8, 9]
    noise = make_enc.moving_frames(64, 48, 0, 5, 3)
    for frames in (cut, noise):
        for kf in (8, 4):
            for auto in (True, False):
                assert gop.gop_starts(frames, kf, auto) == \
                    tpu_gop.gop_starts(frames, kf, auto)
            assert gop.detect_scene_cuts(frames, kf, 40.0) == \
                tpu_gop.detect_scene_cuts(frames, kf, 40.0)
    assert gop.detect_scene_cuts(noise, 8) == list(range(5))


# ------------------------------------------------------- whole encodes

def _encoder(w, h, qi, **kw):
    from theora_tpu_torch.encode.gop import GopEncoder
    from theora_tpu_torch.info import TheoraInfo

    return GopEncoder(TheoraInfo(frame_width=w, frame_height=h, pic_width=w,
                                 pic_height=h, quality=qi), qi=qi,
                      device="cpu", **kw)


def _hashes(pkts):
    return [hashlib.sha256(p.data).hexdigest() for p in pkts]


def _want(name):
    with open(os.path.join(TESTDATA, name)) as f:
        return f.read().split()


def _sp_packets():
    pkts = []
    for lvl in (2, 4):
        enc = _encoder(64, 48, make_enc.SMALL_QI)
        enc.set_splevel(lvl)
        assert enc.use_trellis is False and enc._no_mc == (lvl == 4)
        pkts += enc.encode_clip(
            make_enc.moving_frames(64, 48, 0, make_enc.SMALL_FRAMES, 11),
            keyframe_freq=make_enc.SMALL_KF)
    return pkts


def _rd_packets(frames, qi, mode):
    enc = _encoder(make_enc.MIXED_W, make_enc.MIXED_H, qi,
                   adaptive_quant=mode, use_trellis=False)
    pkts = enc.encode_clip(frames, keyframe_freq=make_enc.MIXED_FRAMES)
    assert enc.nonbase_qi_blocks > 0
    return pkts


def _cut_packets():
    pkts = _encoder(64, 48, make_enc.SMALL_QI).encode_clip(
        make_enc.cut_frames(), keyframe_freq=make_enc.CUT_KF,
        auto_keyframe=True)
    shift = 6
    kfs = [i for i, p in enumerate(pkts[3:])
           if p.granulepos & ((1 << shift) - 1) == 0]
    assert kfs == [0, 8, 9]
    return pkts


ENCODES = {
    "enc64x48_sp24.sha256": _sp_packets,
    "mixed96x64_q40_aq_rd_enc.sha256": lambda: _rd_packets(
        make_enc.mixed_frames(), make_enc.MIXED_QI, True),
    "halftex96x64_q48_aq_rd_enc.sha256": lambda: _rd_packets(
        make_enc.halftexture_frames(), make_enc.HALFTEX_QI, "auto"),
    "cut64x48_autokf_enc.sha256": _cut_packets,
}


@pytest.mark.parametrize("name", list(ENCODES))
def test_encode_packets_equal_jax_lists(name):
    """GopEncoder(device="cpu") against the JAX TpuGopEncoder's packet
    lists: speed levels 2 and 4 at 64x48 (one qi per frame even at
    adaptive quantization "auto"); use_trellis=False at three qi rows on
    the half-smooth, half-noise 96x64 clip (adaptive_quant=True) and on
    the half-texture clip ("auto", with per-block lambda scales in the
    chooser), each coding blocks at a non-base qi; auto_keyframe on the
    clip with a scene cut (keyframes at 0, 8 and 9)."""
    assert _hashes(ENCODES[name]()) == _want(name)


def test_closed_loop_of_rd_quantizer_equals_port_decoder():
    """With the R/D quantizer at three qi rows and lambda scales, the
    reconstruction the encode carries equals the port's BatchDecoder on
    its packets."""
    from theora_tpu_torch.decode.batch import BatchDecoder
    from theora_tpu_torch.headers import parse_info_header, \
        parse_setup_header

    frames = make_enc.halftexture_frames()
    enc = _encoder(make_enc.MIXED_W, make_enc.MIXED_H, make_enc.HALFTEX_QI,
                   use_trellis=False)
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
