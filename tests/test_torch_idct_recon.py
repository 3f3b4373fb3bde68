"""Kernel K1's encode entry: its plain version `transforms.idct_recon_choose`
(the wrapper's CPU path) against the chain it replaced in the encode scan
(the decode entry over K x N (row, block) pairs, then the clamp, the SSD,
`choose_rows` and the gathers as PyTorch ops) and against the JAX scan
step it ports (theora_tpu/encode/tpu_gop.py:231-285, written out over
`transforms_jax.dequantize_idct`). Exact throughout (tolerance 0)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theora_tpu.ops import transforms_jax as tj
from theora_tpu_torch.ops import idct_cuda
from theora_tpu_torch.ops import transforms as tt
from theora_tpu_torch.tools import bench_idct as bi


def _cases():
    rng = np.random.default_rng(7)
    for k in (1, 2, 3):
        for scales in (True, False):
            yield f"random K={k} scales={scales}", bi.recon_inputs(
                rng, 400, k, scales)
    yield "ties with scales", bi.tie_inputs(rng, 300)
    yield "ties without scales", bi.tie_inputs(rng, 300, False)
    yield "lambda terms within one ulp of an integer", bi.ulp_inputs(rng, 600)


CASES = dict(_cases())


@pytest.mark.parametrize("name", list(CASES))
def test_plain_equals_replaced_chain(name):
    """transforms.idct_recon_choose, through the wrapper's CPU path, equals
    the encode scan's earlier chain on the same inputs, all five
    outputs."""
    args = bi.recon_args(CASES[name], "cpu")
    before = idct_cuda.idct_recon_choose.launches
    got = idct_cuda.idct_recon_choose(*args)
    assert idct_cuda.idct_recon_choose.launches == before
    want = bi.parent_chain(tt.dequantize_idct_frames, args)()
    assert got[0].dtype == torch.uint8 and got[2].dtype == torch.uint8
    assert bi.same_outputs(got, want)
    k = args[0].shape[0]
    rows = np.bincount(got[2].numpy(), minlength=3)
    if k > 1:  # the cases make every row win somewhere
        assert (rows[:k] > 0).all(), rows


def test_constructed_ties_keep_the_earlier_row():
    """On the tie cases the earlier row wins exactly where the
    construction says: all rows equal -> row 0; rows 1 and 2 equal -> never
    row 2; rows 0 and 1 equal -> never row 1."""
    args = bi.recon_args(CASES["ties with scales"], "cpu")
    qii = tt.idct_recon_choose(*args)[2].numpy()
    kind = np.arange(len(qii)) % 3
    assert (qii[kind == 0] == 0).all()
    assert (qii[kind == 1] != 2).all() and (qii[kind == 1] == 1).any()
    assert (qii[kind == 2] != 1).all() and (qii[kind == 2] == 0).any()


def test_ulp_cases_turn_on_one_rounding():
    """The ulp cases: the float32 product lam_b * m1 lands one ulp below,
    on and above an integer, and row 1 wins exactly where it lands
    below."""
    q16, dc_only, cnt, deq, inter, pred, cur, lam, sc = CASES[
        "lambda terms within one ulp of an integer"]
    f32 = np.float32
    lam_b = (lam * sc).astype(f32)
    prod = lam_b * (f32(6.0) * cnt[1].astype(f32) + f32(2.0) + f32(6.0))
    t = np.round(prod)
    assert (np.abs(prod - t) <= np.spacing(t.astype(f32))).all()
    below = prod < t
    assert below.any() and (prod == t).any() and (prod > t).any()
    qii = tt.idct_recon_choose(*bi.recon_args(CASES[
        "lambda terms within one ulp of an integer"], "cpu"))[2].numpy()
    assert np.array_equal(qii == 1, below)


def _jax_step(q16, deq, inter, pred, cur, lam, lam_sc):
    """The JAX scan step from the trellis values on (tpu_gop.py:231-285):
    per qi row the counts, DC-only flags, dequant + iDCT, clip, float32
    SSD, and the chooser's cost; the first least cost wins."""
    n = q16.shape[1]
    curi = cur.astype(jnp.int32).reshape(n, 8, 8)
    pred = pred.reshape(n, 8, 8)
    rsf0 = inter == 0
    best = None
    for k in range(q16.shape[0]):
        deq_k = jnp.where(rsf0[:, None], deq[k, 0], deq[k, 1]).astype(
            jnp.int32)
        qdct = q16[k].astype(jnp.int32)
        nzf = (qdct != 0).astype(jnp.float32)
        cnt = nzf.sum(axis=1)
        dc_only = cnt - nzf[:, 0] == 0.0
        residual = tj.dequantize_idct(qdct, deq_k, qdct[:, 0], deq_k[:, 0],
                                      dc_only)
        recon = jnp.clip(residual + pred, 0, 255)
        dr = (recon - curi).astype(jnp.float32)
        ssd = (dr * dr).sum(axis=(1, 2)).astype(jnp.int32)
        cost = (16 * ssd + (lam * lam_sc * (6.0 * cnt + 2.0 + (
            6.0 if k else 0.0))).astype(jnp.int32))
        if best is None:
            best = (cost, qdct, cnt, recon, ssd, jnp.zeros(n, jnp.uint8))
        else:
            win = cost < best[0]
            best = (jnp.where(win, cost, best[0]),
                    jnp.where(win[:, None], qdct, best[1]),
                    jnp.where(win, cnt, best[2]),
                    jnp.where(win[:, None, None], recon, best[3]),
                    jnp.where(win, ssd, best[4]),
                    jnp.where(win, np.uint8(k), best[5]))
    _, qdct, cnt, recon, ssd, qii = best
    return recon.reshape(n, 64), ssd, qii, qdct, cnt.astype(jnp.int32)


@pytest.mark.parametrize("k,scales,ties", [
    (3, True, True), (3, False, False), (2, True, False), (1, True, False)])
def test_plain_equals_jax_scan_step(k, scales, ties):
    """2,000 blocks through the JAX scan step (jitted) and the port's
    plain version; with ties, rows 1 and 2 share a dequant row and a third
    of the blocks copy row 1's values into row 2 (counts and flags stay
    the values' own, as the JAX step derives them)."""
    rng = np.random.default_rng(11 + k)
    qis = (56, 46, 46) if ties else bi.QIS
    q16, _, _, deq, inter, pred, cur, lam, sc = bi.recon_inputs(
        rng, 2000, k, scales, qis=qis)
    if ties:
        q16[2, ::3] = q16[1, ::3]
    cnt = (q16 != 0).sum(axis=2).astype(np.int32)
    dc_only = ~(q16[:, :, 1:] != 0).any(axis=2)
    args = bi.recon_args((q16, dc_only, cnt, deq, inter, pred, cur, lam, sc),
                         "cpu")
    got = tt.idct_recon_choose(*args)
    want = jax.jit(_jax_step)(
        q16, deq, inter, pred, cur, jnp.float32(lam),
        jnp.ones(2000, jnp.float32) if sc is None else sc)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy().astype(np.int64),
                              np.asarray(w).astype(np.int64))
    if ties:
        assert (got[2].numpy()[::3] != 2).all()
