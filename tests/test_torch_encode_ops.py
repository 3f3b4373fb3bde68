"""The encode-side modules of the PyTorch port against their JAX twins,
on the CPU, exact: kernel K2's plain version (fDCT + quantizer), the
trellis (kernel KT's plain version), the ME plan and the host frame
packer.

Parity hazards, each named in a test below: the trellis' float32 prefix
sum order, XLA's multiply-add contraction in the trellis costs, the tie
order of the ME minima, and uint8 arithmetic before a subtraction.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import TESTDATA
from theora_tpu.ops import me_jax
from theora_tpu.ops import pallas_kernels as pk
from theora_tpu.ops import transforms_jax as tj
from theora_tpu_torch import tables
from theora_tpu_torch.encode.gop import trellis_bit_costs
from theora_tpu_torch.ops import fdct_cuda, me, transforms, trellis_cuda
from theora_tpu_torch.quant import dequant_tables_init

# The tests run in several worker processes on a few CPUs: one torch
# thread each (their tensors are small, and idle intra-op threads spin).
torch.set_num_threads(1)

DQ = dequant_tables_init(tables.DEF_QUANT_INFO)


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


# ---------------------------------------------------------------- K2 plain

def _k2_inputs(seed, n):
    rng = np.random.default_rng(seed)
    res = rng.integers(-255, 256, (n, 64)).astype(np.int16)
    # The int16-safe extremes: saturated flat, checkerboard and stripe
    # residuals.
    ext = np.stack([
        np.full(64, 255), np.full(64, -255),
        np.where(np.indices((8, 8)).sum(0) % 2, 255, -255).reshape(64),
        np.where(np.arange(64) % 2, -255, 255),
        np.where(np.arange(64) // 8 % 2, -255, 255),
    ]).astype(np.int16)
    res[:len(ext)] = ext
    deq = rng.integers(8, 4097, (2, 64)).astype(np.int16)
    inter = rng.integers(0, 2, n).astype(np.uint8)
    return res, deq, inter


def test_k2_plain_equals_jax_fdct_and_quantize():
    res, deq, inter = _k2_inputs(7, 20480)
    (q,), d = fdct_cuda.fdct_quantize(_t(res), _t(deq[None]), _t(inter))
    dct = np.asarray(tj.fdct8x8(jnp.asarray(
        res.reshape(-1, 8, 8).astype(np.int32))))
    qj = np.asarray(tj.quantize(jnp.asarray(dct),
                                jnp.asarray(deq[inter].astype(np.int32))))
    assert np.array_equal(d.numpy(), dct)
    assert np.array_equal(q.numpy(), qj)


def test_k2_plain_equals_pallas_kernel_interpreted():
    """fdct_quantize_soa on the SoA transpose of 20,480 blocks, once per
    dequant row (the Pallas kernel takes one; equal shapes compile
    once), exact."""
    res, deq, _ = _k2_inputs(8, 20480)
    soa_in = jnp.asarray(res.astype(np.int32).T)
    for row in (0, 1):
        inter = np.full(len(res), row, np.uint8)
        (q,), _ = fdct_cuda.fdct_quantize(_t(res), _t(deq[None]), _t(inter))
        soa = pk.fdct_quantize_soa(soa_in,
                                   jnp.asarray(deq[row].astype(np.int32)),
                                   interpret=True)
        assert np.array_equal(np.asarray(soa).T, q.numpy())


def test_k2_plain_equals_libtheora_fdct_vectors():
    rec = np.dtype([("x", "<i2", 64), ("y", "<i2", 64)])
    cases = np.fromfile(os.path.join(TESTDATA, "vectors", "fdct_cases.bin"),
                        dtype=rec)
    n = len(cases)
    deq = np.full((2, 64), 8, np.int16)
    (q,), d = fdct_cuda.fdct_quantize(_t(cases["x"]), _t(deq[None]),
                                      torch.zeros(n, dtype=torch.uint8))
    assert n == 512
    assert np.array_equal(d.numpy(), cases["y"])
    qj = np.asarray(tj.quantize(jnp.asarray(cases["y"].astype(np.int32)),
                                jnp.asarray(deq[0].astype(np.int32))))
    assert np.array_equal(q.numpy(), qj)


def test_uint8_residual_is_taken_in_int32():
    """Hazard: uint8 planes are cast to int32 before cur - pred (the JAX
    scan's curf.astype(int32) at tpu_gop.py:202-204). A uint8
    difference would wrap 0 - 255 to 1."""
    from theora_tpu_torch.encode.scan import plane_blocks

    cur = torch.zeros((1, 8, 8), dtype=torch.uint8)
    pred = torch.full((1, 64), 255, dtype=torch.int32)
    res = plane_blocks(cur, 1, 1)[0].to(torch.int32) - pred
    assert int(res.min()) == -255
    _, d = fdct_cuda.fdct_quantize(res.to(torch.int16),
                                   torch.full((1, 2, 64), 8,
                                              dtype=torch.int16),
                                   torch.zeros(1, dtype=torch.uint8))
    want = np.asarray(tj.fdct8x8(jnp.full((1, 8, 8), -255, jnp.int32)))
    assert np.array_equal(d.numpy(), want)


# ------------------------------------------------------------------ trellis

def _trellis_case(dct, qi, qti):
    deq = DQ[qi, 0, qti].astype(np.int32)
    q0 = np.asarray(tj.quantize(jnp.asarray(dct), jnp.asarray(deq)))
    lam = np.array([tables.RD_LAMBDA[0][t][i] for t, i in zip(qti, qi)],
                   np.float32)
    acmin = np.where(qti == 0, 3, 0).astype(np.int32)
    return (dct.astype(np.int32), q0, deq, lam,
            trellis_bit_costs(tables.VP31_HUFF_CODES), acmin)


@jax.jit
def jax_scan_trellis(dct, q, deq, lam_t, lam_sc, nb, acmin):
    """tj.trellis_values as the JAX encoder compiles it: inside the plane
    scan, with the lambda the float32 product of the step's inputs lam_t
    and lam_sc (theora_tpu/encode/tpu_gop.py:226-229). XLA chooses which
    product a multiply-add fuses by the compiled context, and at
    fractional lambdas the standalone jax.jit(tj.trellis_values) forms
    the lone value's cost the other way (ROADMAP.md §3, F4)."""
    def step(carry, x):
        return carry, tj.trellis_values(dct, q, deq, x[0] * x[1], nb, acmin)
    steps = (jnp.stack([lam_t, lam_t]), jnp.stack([lam_sc, lam_sc]))
    return jax.lax.scan(step, 0, steps)[1][0]


def _both_trellis(args):
    ref = np.asarray(jax.jit(tj.trellis_values)(*args))
    got = transforms.trellis_values(*[_t(a) for a in args]).numpy()
    return ref, got


def test_trellis_equals_jax_on_encoder_blocks_and_large_coefficients():
    rng = np.random.default_rng(11)
    res = rng.integers(-255, 256, (6000, 8, 8)).astype(np.int32)
    res[:3000] //= rng.integers(1, 40, (3000, 1, 1))
    dct = np.asarray(tj.fdct8x8(jnp.asarray(res)))
    # |c| up to 2**15: c^2 up to 2**30, prefix sums up to 2**36.
    big = rng.integers(-32768, 32768, (1500, 64)).astype(np.int32)
    dct = np.concatenate([dct, big])
    n = len(dct)
    args = _trellis_case(dct, rng.integers(0, 64, n), rng.integers(0, 2, n))
    ref, got = _both_trellis(args)
    assert np.array_equal(got, ref)
    assert (np.abs(dct) > 32000).any()


@pytest.fixture(scope="module")
def order_cases():
    """The blocks of testdata/vectors/trellis_order_cases.npz as trellis
    inputs, and the JAX trellis' values for them (compiled once)."""
    cases = np.load(os.path.join(TESTDATA, "vectors",
                                 "trellis_order_cases.npz"))
    args = _trellis_case(cases["dct"].astype(np.int32),
                         cases["qi"].astype(np.int64),
                         cases["qti"].astype(np.int64))
    return args, np.asarray(jax.jit(tj.trellis_values)(*args))


def test_trellis_prefix_sum_order_hazard(monkeypatch, order_cases):
    """Hazard: jnp.cumsum of float32 c^2 is not exact, and XLA on the
    CPU adds in chunks of 16 positions. On these blocks (found by
    testdata/make_trellis_cases.py) a sequential sum changes the
    trellis' choice; the port reproduces XLA's order and equals JAX."""
    args, ref = order_cases
    got = transforms.trellis_values(*[_t(a) for a in args]).numpy()
    assert len(args[0]) >= 50
    assert np.array_equal(got, ref)

    # The order itself, on sums that depend on it.
    rng = np.random.default_rng(3)
    c = rng.integers(-32768, 32768, (4000, 64)).astype(np.float32)
    z = c * c
    xla = np.asarray(jax.jit(lambda v: jnp.cumsum(v, axis=1))(z))
    assert np.array_equal(transforms._xla_cumsum16(_t(z)).numpy(), xla)
    seq = np.cumsum(z, axis=1, dtype=np.float32)
    assert not np.array_equal(seq, xla)

    # And the trellis with a sequential sum differs from JAX here.
    monkeypatch.setattr(
        transforms, "_xla_cumsum16",
        lambda v: torch.from_numpy(np.cumsum(v.numpy(), axis=1,
                                             dtype=np.float32)))
    alt = transforms.trellis_values(*[_t(a) for a in args]).numpy()
    assert not np.array_equal(alt, ref)


def test_trellis_multiply_add_contraction_hazard():
    """Hazard: XLA's CPU compiler contracts a*b + c into one fused
    multiply-add (the first product feeds it), so the token cost
    e*e + lam*bits rounds once. The port's _fma equals that; two
    separately rounded float32 ops (or torch.addcmul) need not."""
    rng = np.random.default_rng(5)
    e = rng.integers(-32768, 32768, 20000).astype(np.float32)
    lam = rng.integers(1, 20000, 20000).astype(np.float32)
    nb = rng.integers(1, 30, 20000).astype(np.float32)
    xla = np.asarray(jax.jit(lambda a, l, b: a * a + l * b)(e, lam, nb))
    got = transforms._fma(_t(e), _t(e), _t(lam) * _t(nb)).numpy()
    assert np.array_equal(got, xla)
    separate = (e * e) + (lam * nb)
    assert not np.array_equal(separate, xla)


def test_trellis_fractional_lambda_fma_hazard():
    """Hazard: with adaptive quantization's per-block lambda scales the
    trellis lambda is fractional and lam * bits inexact, so where XLA's
    CPU compiler fuses a multiply-add decides some blocks: inside the
    encoder's scan it forms the lone and the next-lower value's costs as
    fma(lam, bits, e * e) and the EOB cost as fma(lam, bits, P[64] -
    P[i]). On the blocks of testdata/vectors/trellis_fma_cases.npz
    (found by testdata/make_trellis_fma_cases.py: the other placement
    changes them) the port equals JAX in that context, the plain trellis
    and KT's wrapper (lambda 1 times the block's scale) alike."""
    cases = np.load(os.path.join(TESTDATA, "vectors",
                                 "trellis_fma_cases.npz"))
    dct = cases["dct"].astype(np.int32)
    qi = cases["qi"].astype(np.int64)
    qti = cases["qti"].astype(np.int64)
    lam = cases["lam"]
    assert len(dct) >= 20 and lam.dtype == np.float32
    assert (lam != np.round(lam)).all()
    args = list(_trellis_case(dct, qi, qti))
    args[3] = lam
    ref = np.asarray(jax_scan_trellis(*args[:4], np.ones_like(lam),
                                      *args[4:]))
    got = transforms.trellis_values(*[_t(a) for a in args]).numpy()
    assert np.array_equal(got, ref)
    nb = torch.from_numpy(args[4])
    for q, t in sorted(set(zip(qi.tolist(), qti.tolist()))):
        sel = (qi == q) & (qti == t)
        m = int(sel.sum())
        deq = DQ[q, 0].astype(np.int16)
        vals, _, _ = trellis_cuda.trellis_quantize(
            _t(args[1][sel].astype(np.int16))[None],
            _t(dct[sel].astype(np.int16)), _t(deq[None]),
            torch.full((m,), t, dtype=torch.uint8),
            torch.ones(1), nb, _t(lam[sel]))
        assert np.array_equal(vals[0].numpy(), ref[sel]), (q, t)


def test_k2_reciprocal_divide_is_exact():
    """K2 (csrc/fdct_quant.cu) quantizes a DCT value v with dequant value
    d without a divide: q = ((|v| + (d >> 1)) * m) >> 31, m = ceil(2^31 /
    d), where the reference computes 2|v| >= d ? (2|v| + d) // (2d) : 0
    (enquant.c). Proved here over the whole domain, d in [1, 32767] and
    |v| in [0, 32768]:
    (1) (|v| + (d >> 1)) // d equals the reference: both are
        non-decreasing in |v|, the first steps exactly at |v| = j d -
        (d >> 1), and the reference takes j - 1 just below and j at each
        such point (and 0 at 0, the same value at 32768);
    (2) for n = |v| + (d >> 1) in [0, 49151], (n * m) >> 31 == n // d:
        it is non-decreasing in n and equals n // d at every multiple of
        d and one below it (and at 49151);
    and exhaustively over every |v| for each dequant value the encoder's
    tables hold."""
    n_max = 32768 + 16383

    def ref(a, d):
        return np.where(2 * a >= d, (2 * a + d) // (2 * d), 0)

    def kernel(n, d):
        return (n * (((1 << 31) + d - 1) // d)) >> 31

    d_all = np.arange(1, 32768, dtype=np.int64)
    # (1) the steps of (a + h) // d at a = j d - h, 1 <= a <= 32768.
    h = d_all >> 1
    cnt = (32768 + h) // d_all
    d = np.repeat(d_all, cnt)
    j = np.arange(len(d)) - np.repeat(np.cumsum(cnt) - cnt, cnt) + 1
    a = j * d - (d >> 1)
    assert a.min() >= 1 and a.max() <= 32768
    assert np.array_equal(ref(a, d), j)
    assert np.array_equal(ref(a - 1, d), j - 1)
    assert not ref(np.zeros_like(d_all), d_all).any()
    assert np.array_equal(ref(np.full_like(d_all, 32768), d_all),
                          (32768 + h) // d_all)
    # (2) the reciprocal at every multiple of d up to n_max and below it.
    cnt = n_max // d_all + 1
    d = np.repeat(d_all, cnt)
    j = np.arange(len(d)) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    assert np.array_equal(kernel(j * d, d), j)
    assert np.array_equal(kernel(j[j > 0] * d[j > 0] - 1, d[j > 0]),
                          j[j > 0] - 1)
    assert np.array_equal(kernel(np.full_like(d_all, n_max), d_all),
                          n_max // d_all)
    # Exhaustively for the dequant values of the tables.
    a = np.arange(32769, dtype=np.int64)[None, :]
    for dv in np.array_split(np.unique(DQ).astype(np.int64), 8):
        dv = dv[:, None]
        assert np.array_equal(kernel(a + (dv >> 1), dv), ref(a, dv))


def _kt_wrapper(dct, deq, inter, lam):
    """Kernel KT's wrapper on CPU tensors (its plain path) for one frame
    at one qi row: [N, 64] DCT rows, a [2, 64] dequant pair, [N] inter
    flags, the frame's lambda; the round-to-nearest values from the plain
    quantizer, as K2 computes them. Returns the row's (values, counts,
    DC-only flags)."""
    rows = _t(deq.astype(np.int32)[inter.astype(np.int64)])
    q = transforms.quantize(_t(dct.astype(np.int32)), rows).to(torch.int16)
    vals, cnt, dc_only = trellis_cuda.trellis_quantize(
        q[None], _t(dct.astype(np.int16)), _t(deq.astype(np.int16)[None]),
        _t(inter), torch.tensor([lam], dtype=torch.float32),
        torch.from_numpy(trellis_bit_costs(tables.VP31_HUFF_CODES)))
    return vals[0], cnt[0], dc_only[0]


def test_kt_wrapper_equals_jax_on_order_cases(order_cases):
    """Kernel KT's wrapper on CPU tensors (its plain version) on the 97
    blocks whose result depends on the prefix-sum order, one call per
    (qi, frame type) group, as the encoder calls it per plane and frame;
    the card holds the kernel against the same plain version
    (chip_smoke.py)."""
    args, ref = order_cases
    cases = np.load(os.path.join(TESTDATA, "vectors",
                                 "trellis_order_cases.npz"))
    groups = sorted(set(zip(cases["qi"].tolist(), cases["qti"].tolist())))
    assert len(groups) > 10
    for qi, qti in groups:
        sel = (cases["qi"] == qi) & (cases["qti"] == qti)
        vals, cnt, dc_only = _kt_wrapper(
            args[0][sel], DQ[qi, 0], np.full(int(sel.sum()), qti, np.uint8),
            tables.RD_LAMBDA[0][qti][qi])
        assert vals.dtype == torch.int16 and len(vals) == sel.sum()
        assert np.array_equal(vals.numpy(), ref[sel]), (qi, qti)
        nz = ref[sel] != 0
        assert np.array_equal(cnt.numpy(), nz.sum(1))
        assert np.array_equal(dc_only.numpy(), ~nz[:, 1:].any(1))
    assert trellis_cuda.trellis_quantize.launches == 0


def test_kt_wrapper_equals_jax_on_k2_outputs_and_edge_classes():
    """KT's wrapper (CPU path) against the JAX trellis on K2's plain
    outputs for an intra and an inter frame at one qi, values, nonzero
    counts and DC-only flags, with edge classes among the blocks: no
    nonzero AC value (a fixed result), one nonzero value at position 63
    (its combos wrap to position 0) or at position 1 (the first step's
    headroom), and dense +-32767 coefficients."""
    rng = np.random.default_rng(29)
    qi, n = 36, 1000
    deq = DQ[qi, 0].astype(np.int16)
    jit = jax.jit(tj.trellis_values)
    for qti in (0, 1):
        inter = (np.zeros(n, np.uint8) if qti == 0
                 else rng.integers(0, 2, n).astype(np.uint8))
        res = rng.integers(-255, 256, (n, 64)) // rng.integers(1, 40, (n, 1))
        _, d = fdct_cuda.fdct_quantize(_t(res.astype(np.int16)),
                                       _t(deq[None]), _t(inter))
        dct = d.numpy().astype(np.int32)
        rows = deq.astype(np.int32)[inter.astype(np.int64)]
        sign = rng.choice([-1, 1], (n, 64))
        k = np.arange(0, 40, 4)
        dct[k, 1:] = sign[k, 1:] * (rows[k, 1:] // 2 - 1)  # AC all round to 0
        dct[k + 1, 1:] = 0
        dct[k + 1, 63] = sign[k + 1, 63] * rows[k + 1, 63] * (k + 1)
        dct[k + 2, 1:] = 0
        dct[k + 2, 1] = sign[k + 2, 1] * rows[k + 2, 1] * (k + 2)
        dct[k + 3] = sign[k + 3] * 32767
        assert np.abs(dct).max() <= 32767  # K2 writes int16
        lam = tables.RD_LAMBDA[0][qti][qi]
        vals, cnt, dc_only = _kt_wrapper(dct, deq, inter, lam)
        q = np.asarray(tj.quantize(jnp.asarray(dct), jnp.asarray(rows)))
        ref = np.asarray(jit(dct, q, rows, np.full(n, lam, np.float32),
                             trellis_bit_costs(tables.VP31_HUFF_CODES),
                             np.where(inter == 0, 3, 0).astype(np.int32)))
        assert np.array_equal(vals.numpy(), ref)
        nz = ref != 0
        assert np.array_equal(cnt.numpy(), nz.sum(1))
        assert np.array_equal(dc_only.numpy(), ~nz[:, 1:].any(1))
        assert dc_only.numpy()[k].all() and not q[k, 1:].any()
        assert (q[k + 1, 1:] != 0).sum(1).tolist() == [1] * len(k)
        assert (q[k + 2, 1:] != 0).sum(1).tolist() == [1] * len(k)
        assert (np.abs(dct[k + 3]) == 32767).all()
        assert (ref != q).any()  # the trellis moved values


# ----------------------------------------------------------------- ME plan

_PLAN_NAMES = ("mv", "sad_mv", "sad_nomv", "sad_gold", "sad_intra", "cands",
               "cand_sads", "gmv", "sad_gmv", "bmv", "bsad4")


def _luma_clip(h, w):
    """Frames of cif.i420 cropped to h x w, then random noise and a shift
    of it (large vectors), then flat and periodic frames (every candidate
    ties: the tie order decides)."""
    W, H = 352, 288
    raw = np.fromfile(os.path.join(TESTDATA, "cif.i420"), np.uint8)
    fsz = W * H * 3 // 2
    real = [raw[i * fsz:i * fsz + W * H].reshape(H, W)[40:40 + h, 60:60 + w]
            for i in range(min(4, raw.size // fsz))]
    rng = np.random.default_rng(h + w)
    noise = rng.integers(0, 256, (h, w)).astype(np.uint8)
    flat = np.full((h, w), 77, np.uint8)
    stripes = (np.indices((h, w))[1] % 4 * 60).astype(np.uint8)
    frames = real + [noise, np.roll(noise, (2, -5), (0, 1)), flat, flat,
                     stripes, np.roll(stripes, 1, 1)]
    return np.ascontiguousarray(np.stack(frames))


@pytest.mark.parametrize("h,w", [(48, 64), (144, 176)])
def test_me_plan_equals_jax_including_ties(h, w):
    ys = _luma_clip(h, w)
    F = len(ys)
    kf = {0, 4, 6}
    gidx, last = [], 0
    for f in range(1, F):
        last = f if f in kf else last
        gidx.append(last)
    gidx = np.array(gidx, np.int32)
    ref = jax.device_get(me_jax.plan_with_gold(jnp.asarray(ys),
                                               jnp.asarray(gidx)))
    got = me.plan_with_gold(_t(ys), _t(gidx).long())
    for name, r, g in zip(_PLAN_NAMES, ref, got):
        assert np.array_equal(np.asarray(r).astype(np.int64),
                              g.numpy().astype(np.int64)), name
    # plan_from_gop is plan_with_gold with the first frame as gold.
    ref0 = jax.device_get(me_jax.plan_from_gop(jnp.asarray(ys[:4])))
    got0 = me.plan_from_gop(_t(ys[:4]))
    for name, r, g in zip(_PLAN_NAMES, ref0, got0):
        assert np.array_equal(np.asarray(r).astype(np.int64),
                              g.numpy().astype(np.int64)), name


def _limit_clip(h, w):
    """Frames whose vectors reach the search's limits: noise and a cif.i420
    crop, each followed by copies rolled by (+-20, +-17) (past the +-15
    MB clamp, so the 4MV base is clamped to +-13), by (14, -14) and by
    (13, 13) (at the block clamp), and a frame rolled by one pixel."""
    W, H = 352, 288
    raw = np.fromfile(os.path.join(TESTDATA, "cif.i420"), np.uint8)
    real = raw[:W * H].reshape(H, W)[100:100 + h, 120:120 + w]
    noise = np.random.default_rng(h * w).integers(0, 256, (h, w)).astype(
        np.uint8)
    frames = []
    for base in (noise, real):
        frames.append(base)
        frames += [np.roll(base, s, (0, 1)) for s in
                   ((20, 17), (-20, -17), (20, -17), (-20, 17), (14, -14),
                    (13, 13), (1, 0))]
    return np.ascontiguousarray(np.stack(frames))


@pytest.mark.parametrize("h,w", [(48, 64), (144, 176)])
def test_me_plan_at_the_search_limits_equals_jax(h, w):
    """Kernel KM's wrapper on the CPU (its plain path) against JAX, all 11
    outputs exact, where the MB vectors saturate at +-15 full-pel and the
    4MV blocks at +-13; the rows whose cur frame is a keyframe (8) too."""
    from theora_tpu_torch.ops import me_cuda

    ys = _limit_clip(h, w)
    gidx = np.array([0] * 7 + [8] * 8, np.int64)
    ref = jax.device_get(me_jax.plan_with_gold(jnp.asarray(ys),
                                               jnp.asarray(gidx)))
    got = me_cuda.plan_with_gold(_t(ys), _t(gidx))
    for name, r, g in zip(_PLAN_NAMES, ref, got):
        assert g.dtype == torch.int32, name
        assert np.array_equal(np.asarray(r).astype(np.int64),
                              g.numpy().astype(np.int64)), name
    mv, bmv = got[0].numpy(), got[9].numpy()
    assert np.abs(mv).max() == 31 and np.abs(bmv).max() >= 26
    assert me_cuda.plan_with_gold.launches == 0


@pytest.mark.parametrize("h,w", [(48, 64), (144, 176)])
def test_me_plan_on_byte_extremes_and_word_alignment_equals_jax(h, w):
    """The plain plan against JAX, all 11 outputs exact, on the frames of
    tools/bench_me.py:synthetic that reach kernel KM's packed-byte hazards:
    a 0/255 checkerboard then its inverse and an all-0 frame then an
    all-255 one (MB SADs near 65,280, pyramid differences of 1,020), and
    noise rolled so that the vectors and candidates take every residue of
    dx mod 4, in both directions. The card test holds KM to the plain plan
    on the same frames."""
    from theora_tpu_torch.tools import bench_me

    frames = bench_me.synthetic(h, w, h)
    plans = {}
    for label in ("extremes", "alignment"):
        ys = frames[label]
        rows = len(ys) - 1
        gidx = np.where(np.arange(rows) < rows // 2, 0, 2).astype(np.int64)
        ref = jax.device_get(me_jax.plan_with_gold(jnp.asarray(ys),
                                                   jnp.asarray(gidx)))
        got = me.plan_with_gold(_t(ys), _t(gidx))
        for name, r, g in zip(_PLAN_NAMES, ref, got):
            assert np.array_equal(np.asarray(r).astype(np.int64),
                                  g.numpy().astype(np.int64)), (label, name)
        plans[label] = [g.numpy() for g in got]
    # The hazards are reached: SADs near the 16-bit limit, full-pel
    # vectors and candidates at every residue of dx mod 4.
    assert plans["extremes"][2].max() >= 60000
    mv, cands = plans["alignment"][0], plans["alignment"][5]
    assert set((mv[..., 0] // 2 % 4).ravel()) == {0, 1, 2, 3}
    assert set((cands[..., 0] // 2 % 4).ravel()) == {0, 1, 2, 3}


def test_km_source_tables_are_the_radius_order():
    """csrc/me.cu's candidate table is ops/me.py:_radius_order(7); its
    first 25 and 9 entries are the full-pel refine's and the half-pel
    step's orders, which the kernel keys by position."""
    import re

    from theora_tpu_torch.ops import me_cuda

    with open(me_cuda._SRC) as f:
        src = f.read()
    body = src[src.index("kOrder[kCoarse][2] = {"):]
    body = body[:body.index("};")]
    table = [(int(a), int(b))
             for a, b in re.findall(r"\{(-?\d+), (-?\d+)\}", body)]
    order = [tuple(d) for d in me._radius_order(7).tolist()]
    assert table == order
    assert table[:25] == [tuple(d) for d in me._radius_order(2).tolist()]
    assert table[:9] == [tuple(d) for d in me._radius_order(1).tolist()]
    rank = me._refine_rank()
    for k, (dy, dx) in enumerate(table[:25]):
        assert rank[(dy + 2) * 5 + (dx + 2)] == k


# ------------------------------------------------------------------ packer

def _random_plan(g, rng):
    from theora_tpu.constants import FRAME_GOLD, FRAME_NONE, FRAME_PREV, \
        FRAME_SELF

    nf = g.nfrags
    coded = rng.random(nf) < 0.6
    qdct = (rng.integers(-40, 41, (nf, 64))
            * (rng.random((nf, 64)) < 0.15)).astype(np.int16)
    qdct[:, 0] = rng.integers(-300, 300, nf)
    mb_modes = np.where(g.mb_valid, rng.integers(0, 8, g.nmbs), -1).astype(
        np.int32)
    mb_mvs = rng.integers(-31, 32, (g.nmbs, 2)).astype(np.int32)
    frag_mv4 = rng.integers(-31, 32, (nf, 2)).astype(np.int32)
    refi = np.full(nf, FRAME_PREV, np.int32)
    for mbi in np.where(g.mb_valid)[0]:
        ref = {1: FRAME_SELF, 5: FRAME_GOLD, 6: FRAME_GOLD}.get(
            int(mb_modes[mbi]), FRAME_PREV)
        for f in g.mb_maps[mbi].reshape(-1):
            if f >= 0:
                refi[f] = ref
    refi = np.where(coded, refi, FRAME_NONE).astype(np.int32)
    return coded, qdct, mb_modes, mb_mvs, frag_mv4, refi


@pytest.mark.parametrize("fmt,w,h,qi", [(0, 64, 48, 40), (2, 80, 64, 20),
                                        (3, 48, 32, 55)])
def test_packer_equals_host_encoder(fmt, w, h, qi):
    from theora_tpu.encode.encoder import Encoder
    from theora_tpu.info import INTER_FRAME as J_INTER, TheoraInfo as JInfo
    from theora_tpu_torch.encode.packer import FramePacker
    from theora_tpu_torch.info import INTER_FRAME, INTRA_FRAME, TheoraInfo

    kw = dict(frame_width=w, frame_height=h, pic_width=w, pic_height=h,
              quality=qi, pixel_fmt=fmt)
    enc = Encoder(JInfo(**kw))
    enc.qi = qi
    pk_ = FramePacker(TheoraInfo(**kw))
    assert [p.data for p in pk_.flush_headers()] == [
        p.data for p in enc.flush_headers()]
    g = pk_.geometry
    rng = np.random.default_rng(fmt + qi)
    for _ in range(3):
        coded, qdct, modes, mvs, mv4, refi = _random_plan(g, rng)
        assert pk_.pack_frame_plan(
            INTRA_FRAME, qi, np.ones_like(coded), np.full_like(refi, 2),
            None, None, qdct) == enc.pack_frame_plan(
            0, np.ones_like(coded), np.full_like(refi, 2), None, None, qdct)
        enc._frag_mv4 = mv4
        assert pk_.pack_frame_plan(
            INTER_FRAME, qi, coded, refi, modes, mvs, qdct,
            frag_mv4=mv4) == enc.pack_frame_plan(
            J_INTER, coded, refi, modes, mvs, qdct)
