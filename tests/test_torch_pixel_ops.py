"""The port's MC, loop filter, borders and block layout against the JAX
twins, on the same numpy inputs. Integer codec: exact equality."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from theora_tpu.ops import mc_jax
from theora_tpu.ops.loopfilter_jax import loop_filter_plane_jax
from theora_tpu.ops.loopfilter_np import build_bounding_values
from theora_tpu.pipeline import fill_borders as fill_borders_jax
from theora_tpu_torch.ops.loopfilter import loop_filter_plane
from theora_tpu_torch.ops.mc import block_index_grid, blocks_to_plane, \
    mc_predict
from theora_tpu_torch.pipeline import fill_borders

# The tests run in several worker processes on a few CPUs: one torch
# thread each (their tensors are small, and idle intra-op threads spin).
torch.set_num_threads(1)


def _plane(rng, nv, nh, pad_y, pad_x):
    return rng.integers(0, 256, (nv * 8 + 2 * pad_y, nh * 8 + 2 * pad_x),
                        dtype=np.uint8)


@pytest.mark.parametrize("pad_y,pad_x", [(16, 16), (8, 8), (16, 8)])
def test_mc_matches_jax_neighborhood_select(pad_y, pad_x):
    """Direct gathers == block_neighborhoods + mc_select2 over the whole
    offset range the padding covers, for PREV, GOLD and intra."""
    rng = np.random.default_rng(pad_y * 100 + pad_x)
    nv, nh = 5, 6
    n = nv * nh
    prev = _plane(rng, nv, nh, pad_y, pad_x)
    gold = _plane(rng, nv, nh, pad_y, pad_x)
    by = 8 * (mc_jax.window_shifts(pad_y) // 2)
    bx = 8 * (mc_jax.window_shifts(pad_x) // 2)
    y1, y2 = rng.integers(-by, by + 1, (2, n)).astype(np.int8)
    x1, x2 = rng.integers(-bx, bx + 1, (2, n)).astype(np.int8)
    y1[:4] = [-by, by, -by, by]
    x1[:4] = [-bx, bx, bx, -bx]
    rs = rng.integers(0, 3, n).astype(np.int8)
    u2 = (rng.random(n) < 0.5) & (rs != 0)

    nb_p = mc_jax.block_neighborhoods(jnp.asarray(prev), nv, nh, pad_y, pad_x)
    nb_g = mc_jax.block_neighborhoods(jnp.asarray(gold), nv, nh, pad_y, pad_x)
    nb = jnp.where(jnp.asarray(rs == 2)[:, None, None], nb_g, nb_p)
    s1, s2 = mc_jax.mc_select2(nb, *map(jnp.asarray, (y1, x1, y2, x2)),
                               pad_y, pad_x)
    sel = jnp.where(jnp.asarray(u2)[:, None, None], (s1 + s2) >> 1, s1)
    ref = np.asarray(jnp.where(jnp.asarray(rs == 0)[:, None, None], 128, sel))

    t = torch.from_numpy
    grid = block_index_grid(nv, nh, pad_y, pad_x, prev.shape[1], "cpu")
    out = mc_predict(t(prev), t(gold), grid, t(rs), t(y1), t(x1), t(y2),
                     t(x2), t(u2))
    assert out.dtype == torch.int32
    assert np.array_equal(out.numpy(), ref)


@pytest.mark.parametrize("pad_y,pad_x", [(16, 16), (8, 8)])
def test_blocks_to_plane_matches_jax(pad_y, pad_x):
    rng = np.random.default_rng(2)
    nv, nh = 4, 7
    blocks = rng.integers(0, 256, (nv * nh, 8, 8), dtype=np.uint8)
    ref = np.asarray(mc_jax.blocks_to_plane(jnp.asarray(blocks), nv, nh,
                                            pad_y, pad_x))
    out = blocks_to_plane(torch.from_numpy(blocks), nv, nh, pad_y, pad_x)
    assert np.array_equal(out.numpy(), ref)


@pytest.mark.parametrize(
    "nv,nh,pad_y,pad_x,seed",
    [(5, 7, 16, 16, 17), (6, 4, 8, 8, 18), (3, 9, 16, 8, 19),
     (1, 5, 16, 16, 20), (4, 1, 8, 8, 21)],
)
def test_loop_filter_matches_jax(nv, nh, pad_y, pad_x, seed):
    """Random planes, coded masks and limits across 0..63 (limit 0 leaves
    the plane as it is, as the JAX filter with an all-zero table does)."""
    rng = np.random.default_rng(seed)
    for limit in (0, 1, 7, 23, 40, 63):
        img = _plane(rng, nv, nh, pad_y, pad_x)
        coded = rng.random((nv, nh)) < 0.6
        bv = build_bounding_values(limit).astype(np.int32)
        ref = np.asarray(loop_filter_plane_jax(
            jnp.asarray(img), jnp.asarray(coded), jnp.asarray(bv), nv, nh,
            pad_y, pad_x))
        out = loop_filter_plane(torch.from_numpy(img),
                                torch.from_numpy(coded), limit, nv, nh,
                                pad_y, pad_x)
        assert out.dtype == torch.uint8
        assert np.array_equal(out.numpy(), ref), f"limit {limit}"
        if limit == 0:
            assert np.array_equal(out.numpy(), img)


@pytest.mark.parametrize("h,w,vpad,hpad", [(48, 64, 16, 16), (24, 32, 8, 8),
                                           (48, 32, 16, 8)])
def test_fill_borders_matches_jax(h, w, vpad, hpad):
    rng = np.random.default_rng(h + w)
    plane = rng.integers(0, 256, (h + 2 * vpad, w + 2 * hpad), dtype=np.uint8)
    ref = np.asarray(fill_borders_jax(jnp.asarray(plane), h, w, vpad, hpad))
    out = fill_borders(torch.from_numpy(plane.copy()), h, w, vpad, hpad)
    assert np.array_equal(out.numpy(), ref)
