"""Kernel KS's wrappers (ops/mc_cuda.py: mc_residual, skip_place with its
split form skip_rows / place_rows, mc_recon) on the CPU, where they run
their plain versions (ops/mc.py), against the JAX package's steps on the
same numpy inputs, exactly: the encode scan's MC and residual
(theora_tpu/encode/tpu_gop.py:182-200, 286-288: mc_jax.block_neighborhoods,
mc_select2, the half-pel average, intra 128, the uncoded SSD), its skip
test and the plane's assembly (tpu_gop.py:286-316: the lambda term in
float32, mc_jax.blocks_to_plane, loop_filter_plane_jax,
pipeline.fill_borders), and the decode step (theora_tpu/decode/
tpu_batch.py:114-128). Inputs come from tools/bench_mc.py's generators
(the ones chip_smoke.py holds the kernel to its plain version on): MVs
at the padding's extremes in every corner, every reference and half-pel
flag, 3 segments with their own lambdas, frag subsets with clamped pads,
skip ties and lambdas one ulp from an integer product, unfiltered and
filtered steps. And the entries that fuse KS into the scan's kernels
(fdct_cuda.mc_fdct_quantize, qrd_cuda.mc_fdct_quantize_rd,
idct_cuda.mc_idct_recon_skip), whose CPU paths compose the plain
versions, against the JAX scan step from MC to the plane, on
bench_mc.fused_inputs. The kernels themselves run on the card
(tests/test_torch_card.py, chip_smoke.py phase 6f)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theora_tpu.ops import mc_jax
from theora_tpu.ops import transforms_jax as tj
from theora_tpu.ops.loopfilter_jax import loop_filter_plane_jax
from theora_tpu.ops.loopfilter_np import build_bounding_values
from theora_tpu.pipeline import fill_borders as fill_borders_jax
from theora_tpu_torch.ops import loopfilter_cuda, mc_cuda
from theora_tpu_torch.tools import bench_mc as bm

# (label, nv, nh, pad_y, pad_x): 64x48 and 96x64 luma, the chroma planes
# of 4:2:0, 4:2:2 and 4:4:4 frames.
GEOMS = {"luma 64x48": (6, 8, 16, 16), "luma 96x64": (8, 12, 16, 16),
         "4:2:0 chroma": (3, 4, 8, 8), "4:2:2 chroma": (6, 4, 16, 8),
         "4:4:4 chroma": (8, 12, 16, 16)}
LIMIT = 5


def _seed(*key) -> int:
    """A seed for a case, the same in every process."""
    return sum(ord(c) for c in repr(key))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _jax_pred(prev, gold, side, fi, nv, nh, pad_y, pad_x):
    """tpu_gop.py:182-197 for one plane: the prediction [nl, 8, 8] and the
    uncoded blocks of fragments fi."""
    nb_p = mc_jax.block_neighborhoods(prev, nv, nh, pad_y, pad_x)
    nb_g = mc_jax.block_neighborhoods(gold, nv, nh, pad_y, pad_x)
    unc = jnp.take(mc_jax.plane_to_blocks(prev, nv, nh, pad_y, pad_x), fi,
                   axis=0)
    rsf, y1, x1, y2, x2, u2 = side
    nbs = jnp.where((rsf == 2)[:, None, None], jnp.take(nb_g, fi, axis=0),
                    jnp.take(nb_p, fi, axis=0))
    s1, s2 = mc_jax.mc_select2(nbs, y1, x1, y2, x2, pad_y, pad_x)
    selv = jnp.where((u2 != 0)[:, None, None], (s1 + s2) >> 1, s1)
    return jnp.where((rsf == 0)[:, None, None], 128, selv), \
        unc.astype(jnp.int32)


@functools.partial(jax.jit, static_argnums=(5, 6, 7, 8))
def _jax_mc(prev, gold, side, fi, cur, nv, nh, pad_y, pad_x):
    """tpu_gop.py:182-200, 286-288 for one plane: (pred, res = cur - pred,
    ssd_unc), the SSD summed in float32."""
    pred, unc = _jax_pred(prev, gold, side, fi, nv, nh, pad_y, pad_x)
    curi = cur.reshape(-1, 8, 8).astype(jnp.int32)
    du = (unc - curi).astype(jnp.float32)
    return pred, curi - pred, (du * du).sum(axis=(1, 2)).astype(jnp.int32)


@functools.partial(jax.jit, static_argnums=(3, 4, 5, 6, 7))
def _jax_plane(blocks, coded, bv, filtered, nv, nh, pad_y, pad_x):
    """tpu_gop.py:308-316 / tpu_batch.py:124-128: blocks_to_plane, the
    filter with bounding values bv where filtered, fill_borders."""
    plane = mc_jax.blocks_to_plane(blocks.reshape(-1, 8, 8), nv, nh, pad_y,
                                   pad_x)
    if filtered:
        plane = loop_filter_plane_jax(plane, coded.reshape(nv, nh), bv, nv,
                                      nh, pad_y, pad_x)
    return fill_borders_jax(plane, 8 * nv, 8 * nh, pad_y, pad_x)


def _plane(blocks, coded, limit, nv, nh, pad_y, pad_x):
    bv = build_bounding_values(limit).astype(np.int32)
    return np.asarray(_jax_plane(jnp.asarray(blocks), jnp.asarray(coded),
                                 jnp.asarray(bv), bool(limit), nv, nh,
                                 pad_y, pad_x))


def _segments(n, fid):
    return np.arange(n) if fid is None else fid


@pytest.mark.parametrize("geom,G,frag,same_gold", [
    ("luma 64x48", 1, None, False),
    ("luma 96x64", 3, None, True),
    ("4:2:0 chroma", 3, (2, 1), False),
    ("4:2:2 chroma", 3, None, False),
    ("4:4:4 chroma", 1, (3, 0), False),
    ("luma 64x48", 3, (5, 4), False),
])
def test_mc_residual_matches_jax(geom, G, frag, same_gold):
    """pred, res and ssd_unc of N = G nl blocks against tpu_gop.py:
    182-200 and 286-288 per segment (a frag group's share takes its
    fragments; (5, 4) ends in clamped pads)."""
    nv, nh, pad_y, pad_x = GEOMS[geom]
    n = nv * nh
    fid = None if frag is None else bm.shard(n, *frag)
    rng = np.random.default_rng(_seed(geom, G))
    d = bm.residual_inputs(rng, G, nv, nh, pad_y, pad_x, fid, same_gold)
    prev = _t(d["prev"])
    gold = prev if same_gold else _t(d["gold"])
    pred, res, ssd = mc_cuda.mc_residual(
        prev, gold, _t(d["cur"]), _t(d["side"]), nv, nh, pad_y, pad_x,
        None if fid is None else _t(fid))
    assert (pred.dtype, res.dtype, ssd.dtype) == (torch.int32, torch.int16,
                                                  torch.int32)
    fi = _segments(n, fid)
    nl = len(fi)
    for g in range(G):
        sl = slice(g * nl, (g + 1) * nl)
        p, r, u = _jax_mc(d["prev"][g], d["gold"][g], d["side"][:, sl], fi,
                          d["cur"][sl], nv, nh, pad_y, pad_x)
        assert np.array_equal(pred[sl].numpy(),
                              np.asarray(p).reshape(nl, 64)), g
        assert np.array_equal(res[sl].numpy(),
                              np.asarray(r).reshape(nl, 64)), g
        assert np.array_equal(ssd[sl].numpy(), np.asarray(u)), g
    # The corners' offsets reach the padding's far ends.
    lim = bm.mv_limit(pad_y)
    assert np.abs(d["side"][1]).max() == lim
    assert mc_cuda.mc_residual.launches == 0


def _skip_case(geom, G, intra, seed, fid=None):
    nv, nh, pad_y, pad_x = GEOMS[geom]
    rng = np.random.default_rng(seed)
    d = bm.residual_inputs(rng, G, nv, nh, pad_y, pad_x, fid)
    s = bm.skip_inputs(rng, G, d["cur"].shape[0])
    return d, s


@functools.partial(jax.jit, static_argnums=(9, 10, 11, 12, 13))
def _jax_skip_one(prev, recon, q16, ssd_rec, ssd_unc, cnt, ms, lam, fi,
                  intra, nv, nh, pad_y, pad_x):
    """tpu_gop.py:286-298, 314 for one plane's blocks (cnt in float32, as
    the scan carries it)."""
    unc = jnp.take(mc_jax.plane_to_blocks(prev, nv, nh, pad_y, pad_x), fi,
                   axis=0)
    lamterm = (lam * (6.0 * cnt.astype(jnp.float32) + 2.0)).astype(
        jnp.int32)
    skip = ms & (16 * ssd_unc <= 16 * ssd_rec + lamterm) & (not intra)
    coded = ~skip
    blocks = jnp.where(coded[:, None, None],
                       recon.reshape(-1, 8, 8).astype(jnp.int32),
                       unc.astype(jnp.int32)).astype(jnp.uint8)
    return coded, blocks.reshape(-1, 64), \
        jnp.where(coded[:, None], q16, 0).astype(jnp.int16)


def _jax_skip(d, s, G, intra, nv, nh, pad_y, pad_x, fi):
    """_jax_skip_one per segment: (coded [N], kept blocks [N, 64] uint8,
    qout [N, 64] int16)."""
    nl = len(fi)
    outs = [_jax_skip_one(
        d["prev"][g], *(s[k][g * nl:(g + 1) * nl] for k in (
            "recon", "q16", "ssd_rec", "ssd_unc", "cnt", "ms")),
        s["lam"][g], fi, intra, nv, nh, pad_y, pad_x) for g in range(G)]
    return tuple(np.concatenate([np.asarray(o[i]) for o in outs])
                 for i in range(3))


def _skip_args(d, s, intra, N):
    return (_t(d["prev"]), _t(s["recon"]), _t(s["q16"]), _t(s["ssd_rec"]),
            _t(s["ssd_unc"]), _t(s["cnt"]), _t(s["ms"]), _t(s["lam"]),
            intra, torch.full((N, 64), 9, dtype=torch.int16),
            torch.zeros(N, dtype=torch.bool))


@pytest.mark.parametrize("geom,G,intra,limit", [
    ("luma 64x48", 1, False, 0),
    ("luma 96x64", 3, False, LIMIT),
    ("4:2:0 chroma", 3, True, 0),
    ("4:2:2 chroma", 3, False, 0),
    ("4:4:4 chroma", 3, False, LIMIT),
    ("luma 64x48", 3, True, LIMIT),
])
def test_skip_place_matches_jax(geom, G, intra, limit):
    """qout, coded and the new plane against tpu_gop.py:286-316 per
    segment: unfiltered (limit 0) the plane with its borders; filtered,
    the plane with zero padding equals blocks_to_plane's and, through
    KL, the filtered plane with its borders. Ties skip; a lambda one ulp
    below 16 m / t codes a block whose lambda one ulp above skips."""
    nv, nh, pad_y, pad_x = GEOMS[geom]
    n = nv * nh
    d, s = _skip_case(geom, G, intra, _seed(geom, G, intra))
    args = _skip_args(d, s, intra, G * n)
    plane = mc_cuda.skip_place(*args, nv, nh, pad_y, pad_x,
                               borders=limit == 0)
    coded, blocks, qout = _jax_skip(d, s, G, intra, nv, nh, pad_y, pad_x,
                                    np.arange(n))
    assert np.array_equal(args[10].numpy(), coded)
    assert np.array_equal(args[9].numpy(), qout)
    if limit:
        filtered = loopfilter_cuda.loop_filter_plane(
            plane, args[10].view(G, nv, nh),
            torch.full((G,), limit, dtype=torch.int32), nv, nh, pad_y,
            pad_x)
    for g in range(G):
        sl = slice(g * n, (g + 1) * n)
        want = _plane(blocks[sl], coded[sl], limit, nv, nh, pad_y, pad_x)
        if limit:
            assert np.array_equal(plane[g].numpy(), np.asarray(
                mc_jax.blocks_to_plane(jnp.asarray(blocks[sl]).reshape(
                    n, 8, 8), nv, nh, pad_y, pad_x))), g
            assert np.array_equal(filtered[g].numpy(), want), g
        else:
            assert np.array_equal(plane[g].numpy(), want), g
    if intra:
        assert coded.all()
        return
    seg = np.arange(G * n) // n % 3
    lt = (s["lam"][np.arange(G * n) // n] * (
        np.float32(6) * s["cnt"].astype(np.float32) + np.float32(2))
    ).astype(np.int32)
    tie = s["ms"] & (16 * s["ssd_unc"] == 16 * s["ssd_rec"] + lt)
    assert tie.any() and not coded[tie].any()
    near = s["ms"] & (s["cnt"] == 3) & (s["ssd_unc"] - s["ssd_rec"] == 7)
    if G == 3:
        assert coded[near & (seg == 1)].all() and near[seg == 1].any()
        assert not coded[near & (seg == 2)].any() and near[seg == 2].any()
    assert mc_cuda.skip_place.launches == 0


@pytest.mark.parametrize("size,limit", [(2, 0), (5, LIMIT)])
def test_split_form_matches_jax(size, limit):
    """Over a frag group of `size` ranks (3 segments of the 96x64 luma
    plane): skip_rows on each rank's share writes its qout and coded and
    returns its rows; the gather in FragGroup.whole's order; place_rows
    gives the plane (its borders when unfiltered) and the coded flags.
    Both equal JAX's step over every fragment, and skip_place."""
    geom, G = "luma 96x64", 3
    nv, nh, pad_y, pad_x = GEOMS[geom]
    n = nv * nh
    d, s = _skip_case(geom, G, False, 17 + size)
    coded, blocks, qout = _jax_skip(d, s, G, False, nv, nh, pad_y, pad_x,
                                    np.arange(n))
    parts = []
    for r in range(size):
        fid = bm.shard(n, size, r)
        nl = len(fid)
        pick = (np.arange(G)[:, None] * n + fid[None]).reshape(-1)
        sr = {k: v[pick] if k != "lam" else v for k, v in s.items()}
        args = _skip_args(d, sr, False, G * nl)
        rows = mc_cuda.skip_rows(*args, nv, nh, pad_y, pad_x, _t(fid))
        assert rows.shape == (G * nl, 65) and rows.dtype == torch.uint8
        assert np.array_equal(args[10].numpy(), coded[pick]), r
        assert np.array_equal(args[9].numpy(), qout[pick]), r
        assert np.array_equal(rows[:, :64].numpy(), blocks[pick]), r
        assert np.array_equal(rows[:, 64].numpy(), coded[pick]), r
        parts.append(rows.view(G, nl, 65))
    rows = torch.stack(parts).movedim(0, 1).reshape(G, -1, 65)[:, :n] \
        .reshape(G * n, 65).contiguous()
    plane, coded_all = mc_cuda.place_rows(rows, G, nv, nh, pad_y, pad_x,
                                          borders=limit == 0)
    assert np.array_equal(coded_all.numpy(), coded)
    whole = mc_cuda.skip_place(*_skip_args(d, s, False, G * n), nv, nh,
                               pad_y, pad_x, borders=limit == 0)
    assert torch.equal(plane, whole)
    if limit:
        plane = loopfilter_cuda.loop_filter_plane(
            plane, coded_all.view(G, nv, nh),
            torch.full((G,), limit, dtype=torch.int32), nv, nh, pad_y,
            pad_x)
    for g in range(G):
        sl = slice(g * n, (g + 1) * n)
        assert np.array_equal(plane[g].numpy(), _plane(
            blocks[sl], coded[sl], limit, nv, nh, pad_y, pad_x)), g
    assert mc_cuda.skip_rows.launches == mc_cuda.place_rows.launches == 0


@pytest.mark.parametrize("geom,limit,same_gold", [
    ("luma 64x48", 0, False),
    ("luma 96x64", LIMIT, False),
    ("4:2:0 chroma", 0, True),
    ("4:2:2 chroma", LIMIT, False),
    ("4:4:4 chroma", 0, False),
])
def test_mc_recon_matches_jax(geom, limit, same_gold):
    """The decode step against tpu_batch.py:114-128: unfiltered, the plane
    with its borders and the picture region; filtered, the plane with zero
    padding and, through KL, the filtered plane with its borders."""
    nv, nh, pad_y, pad_x = GEOMS[geom]
    n = nv * nh
    rng = np.random.default_rng(_seed(geom, limit))
    d = bm.recon_inputs(rng, nv, nh, pad_y, pad_x, same_gold)
    coded = rng.random(n) < 0.6
    prev = _t(d["prev"])
    gold = prev if same_gold else _t(d["gold"])
    pic = None if limit else torch.zeros((8 * nv, 8 * nh),
                                         dtype=torch.uint8)
    plane = mc_cuda.mc_recon(prev, gold, _t(d["resid"]), _t(d["side"]), nv,
                             nh, pad_y, pad_x, borders=limit == 0, pic=pic)
    pred, _, _ = _jax_mc(d["prev"], d["gold"], d["side"], np.arange(n),
                         np.zeros((n, 64), np.uint8), nv, nh, pad_y, pad_x)
    blocks = np.clip(d["resid"].reshape(n, 8, 8).astype(np.int32)
                     + np.asarray(pred), 0, 255).astype(np.uint8)
    want = _plane(blocks, coded, limit, nv, nh, pad_y, pad_x)
    if limit:
        assert np.array_equal(plane.numpy(), np.asarray(
            mc_jax.blocks_to_plane(blocks, nv, nh, pad_y, pad_x)))
        plane = loopfilter_cuda.loop_filter_plane(
            plane, _t(coded.reshape(nv, nh)), limit, nv, nh, pad_y, pad_x)
    assert np.array_equal(plane.numpy(), want)
    if pic is not None:
        assert np.array_equal(pic.numpy(), want[pad_y:pad_y + 8 * nv,
                                                pad_x:pad_x + 8 * nh])
    assert torch.equal(prev, _t(d["prev"]))
    assert mc_cuda.mc_recon.launches == 0


@pytest.mark.parametrize("geom", ["luma 64x48", "4:2:2 chroma"])
def test_kl_output_does_not_depend_on_input_padding(geom):
    """KL (its CPU path: the plain filter, then the borders) gives the
    same plane from an input whose padding is random as from one whose
    padding is zero (blocks_to_plane's), at limits 1, 5 and 63 over coded
    densities 0.3 to 1. KS writes zeros there on a filtered step all the
    same, as the plain chain did."""
    nv, nh, pad_y, pad_x = GEOMS[geom]
    rng = np.random.default_rng(3)
    hp, wp = bm.plane_shape(nv, nh, pad_y, pad_x)
    for limit in (1, 5, 63):
        for density in (0.3, 0.7, 1.0):
            img = rng.integers(0, 256, (hp, wp), dtype=np.uint8)
            zero = np.zeros_like(img)
            zero[pad_y:hp - pad_y, pad_x:wp - pad_x] = \
                img[pad_y:hp - pad_y, pad_x:wp - pad_x]
            coded = _t(rng.random((nv, nh)) < density)
            a = loopfilter_cuda.loop_filter_plane(_t(img), coded, limit, nv,
                                                  nh, pad_y, pad_x)
            b = loopfilter_cuda.loop_filter_plane(_t(zero), coded, limit,
                                                  nv, nh, pad_y, pad_x)
            assert torch.equal(a, b), (limit, density)


# ------------------------------------------- KS fused into K2, KR and K1

_jax_fdct = jax.jit(tj.fdct8x8)
_jax_quant = jax.jit(tj.quantize)
_jax_qrd = jax.jit(tj.quantize_rd)


def _per_block(rows, inter, fi_n, G):
    """[G, K, 2, 64] segment rows -> [K, N, 64] per block by segment and
    type."""
    seg = np.arange(G * fi_n) // fi_n
    return rows[seg, :, (inter != 0).astype(np.int64)].transpose(1, 0, 2)


def _jax_head(d, G, path, fi, geom):
    """The JAX scan step before the quantizer's output (tpu_gop.py:
    182-236 per segment): MC and the residual, fdct8x8, then quantize (the
    trellis path's K2 outputs: values at each row and the DCT) or
    quantize_rd at each row (the R/D path: values, counts, DC-only
    flags); and each segment's prediction and uncoded SSD."""
    nl = len(fi)
    preds, res, uncs = [], [], []
    for g in range(G):
        sl = slice(g * nl, (g + 1) * nl)
        p, r, u = _jax_mc(d["prev"][g], d["gold"][g], d["side"][:, sl], fi,
                          d["cur"][sl], *geom)
        preds.append(np.asarray(p).reshape(nl, 64))
        res.append(np.asarray(r))
        uncs.append(np.asarray(u))
    dct = np.asarray(_jax_fdct(jnp.asarray(np.concatenate(res))))
    rows = _per_block(d["deq"], d["inter"], nl, G).astype(np.int32)
    if path == "trellis":
        q = np.stack([np.asarray(_jax_quant(dct, r)) for r in rows])
        head = (q.astype(np.int16), dct.astype(np.int16))
    else:
        lam = _per_block(d["lam_q"][..., None], d["inter"], nl, G)[..., 0]
        q = np.stack([np.asarray(_jax_qrd(dct, r, lam_k))
                      for r, lam_k in zip(rows, lam)])
        nz = q != 0
        head = (q.astype(np.int16), nz.sum(axis=2).astype(np.int32),
                ~nz[:, :, 1:].any(axis=2))
    return head, np.concatenate(preds), np.concatenate(uncs)


@pytest.mark.parametrize("geom,G,frag,K,path,intra,limit", [
    ("luma 64x48", 1, None, 1, "trellis", False, 0),
    ("luma 96x64", 3, None, 3, "rd", False, LIMIT),
    ("4:2:0 chroma", 3, (2, 1), 3, "trellis", False, 0),
    ("luma 64x48", 3, None, 1, "trellis", True, 0),
])
def test_fused_entries_match_jax(geom, G, frag, K, path, intra, limit):
    """The fused head (fdct_cuda.mc_fdct_quantize on the trellis path,
    qrd_cuda.mc_fdct_quantize_rd on the R/D path) and K1's fused entry
    (idct_cuda.mc_idct_recon_skip) on their CPU paths against the JAX
    scan step on bench_mc.fused_inputs: MC, fdct8x8 and quantize or
    quantize_rd (tpu_gop.py:182-236), then dequant + iDCT, the chooser,
    the skip test and the plane (tpu_gop.py:231-316, through KL where the
    step filters; its rows over a frag group's share), exactly. The
    engineered blocks decide the skip test on one float32 ulp of the
    lambda: skipped at 8 (a tie) and one ulp above, coded one ulp
    below."""
    from tests.test_torch_idct_recon import _jax_step
    from theora_tpu_torch.ops import idct_cuda

    nv, nh, pad_y, pad_x = GEOMS[geom]
    g4 = (nv, nh, pad_y, pad_x)
    n = nv * nh
    fid = None if frag is None else bm.shard(n, *frag)
    fi = _segments(n, fid)
    nl = len(fi)
    d = bm.fused_inputs(np.random.default_rng(_seed(geom, G, K, path)), G,
                        *g4, K, fid, scales=K == 3)
    t = bm.fused_tensors(d, "cpu")
    head, pred, unc = _jax_head(d, G, path, fi, g4)
    got = bm.head(t, g4, path)
    for a, b in zip(got, head):
        assert np.array_equal(a.numpy(), b)
    q = bm.quantized(t, g4, path)
    out = bm.tail_outputs(t)
    kept = idct_cuda.mc_idct_recon_skip(*bm.tail_args(
        t, g4, q, intra, limit == 0, out))
    q16, cnt, _ = (x.numpy() for x in q)
    sc = np.ones(G * nl, np.float32) if d["lam_sc"] is None else d["lam_sc"]
    for g in range(G):
        sl = slice(g * nl, (g + 1) * nl)
        recon, ssd, qii, qsel, csel = jax.jit(_jax_step)(
            q16[:, sl], d["deq"][g], d["inter"][sl], pred[sl],
            d["cur"][sl], jnp.float32(d["lam"][g]), sc[sl])
        assert np.array_equal(out[2][sl].numpy(), np.asarray(qii)), g
        coded, blocks, qout = (np.asarray(x) for x in _jax_skip_one(
            d["prev"][g], recon.astype(jnp.uint8), qsel, ssd, unc[sl],
            csel, d["ms"][sl], d["lam"][g], fi, intra, *g4))
        assert np.array_equal(out[0][sl].numpy(), qout), g
        assert np.array_equal(out[1][sl].numpy(), coded), g
        if fid is not None:
            assert np.array_equal(kept[sl, :64].numpy(), blocks), g
            assert np.array_equal(kept[sl, 64].numpy(), coded), g
            continue
        want = _plane(blocks, coded, limit, *g4)
        plane = kept[g]
        if limit:
            assert np.array_equal(plane.numpy(), np.asarray(
                mc_jax.blocks_to_plane(jnp.asarray(blocks).reshape(
                    n, 8, 8), *g4))), g
            plane = loopfilter_cuda.loop_filter_plane(
                plane, torch.tensor(coded.reshape(nv, nh)), limit, *g4)
        assert np.array_equal(plane.numpy(), want), g
    if intra:
        assert out[1].all()
    elif fid is None:
        seg = np.arange(G * nl) // nl % 3
        coded = out[1].numpy()
        tie = d["tie"]
        assert tie[seg != 1].any() and not coded[tie & (seg != 1)].any()
        assert (tie[seg == 1].any() or G == 1) and coded[tie & (seg == 1)].all()
    if K == 3:
        assert len(np.unique(out[2].numpy())) > 1
