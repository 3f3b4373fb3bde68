"""Kernel KL's wrapper (ops/loopfilter_cuda.py:loop_filter_plane) on the
CPU, where it runs its plain version, against the JAX filter
(theora_tpu/ops/loopfilter_jax.py:loop_filter_plane_jax) and the scalar
libtheora-order filter (theora_tpu/ops/loopfilter_np.py), byte for byte;
and the work split of its one launch: CTA r's output rows follow from the
pre-filter window of fragment rows r - 1 and r alone. The kernel itself
runs on the card (tests/test_torch_card.py, chip_smoke.py phase 6e)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theora_tpu.ops.loopfilter_jax import loop_filter_plane_jax
from theora_tpu.ops.loopfilter_np import build_bounding_values
from theora_tpu.ops.loopfilter_np import loop_filter_plane as scalar_filter
from theora_tpu_torch.ops import loopfilter_cuda
from theora_tpu_torch.tools.bench_loopfilter import patterns, pixels, \
    plane_shape

# (nv, nh, pad): an odd nv, one fragment row, one block column. The
# scalar filter takes one padding for both axes.
SHAPES = [(5, 6, 8), (1, 7, 8), (4, 1, 16)]
LIMITS = (1, 2, 15, 63)
KINDS = ("low contrast", "noise", "0/255")


def _reference(img, coded, limit, nv, nh, pad):
    bv = build_bounding_values(limit).astype(np.int32)
    jx = np.asarray(loop_filter_plane_jax(
        jnp.asarray(img), jnp.asarray(coded), jnp.asarray(bv), nv, nh, pad,
        pad))
    sc = img.copy()
    scalar_filter(sc, coded, bv)
    assert np.array_equal(jx, sc)
    return jx


@pytest.mark.parametrize("nv,nh,pad", SHAPES)
def test_kl_wrapper_matches_jax_and_scalar_order(nv, nh, pad):
    """Every pattern of bench_loopfilter.patterns (densities 0 to 1, a
    checkerboard, vE beside vL, stairs, one coded block at each corner
    and all four) at limits 1, 2, 15 and 63 over low-contrast, uniform
    and 0/255 pixels."""
    rng = np.random.default_rng(nv * 100 + nh)
    i = 0
    for name, coded in patterns(nv, nh, rng).items():
        for limit in LIMITS:
            kind = KINDS[i % len(KINDS)]
            i += 1
            img = pixels(rng, plane_shape(nv, nh, pad, pad), kind)
            want = _reference(img, coded, limit, nv, nh, pad)
            got = loopfilter_cuda.loop_filter_plane(
                torch.from_numpy(img), torch.from_numpy(coded), limit, nv,
                nh, pad, pad)
            assert got.dtype == torch.uint8
            assert np.array_equal(got.numpy(), want), (name, limit, kind)
    assert loopfilter_cuda.loop_filter_plane.launches == 0


def test_kl_wrapper_three_planes_with_a_zero_limit():
    """G = 3 planes in one call with limits [5, 0, 31]: each plane equals
    the JAX and scalar filters at its own limit; the zero-limit plane is
    returned as it was."""
    nv, nh, pad = SHAPES[0]
    rng = np.random.default_rng(7)
    pats = patterns(nv, nh, rng)
    coded = np.stack([pats[k] for k in ("density 0.6", "vE beside vL",
                                        "checkerboard")])
    limits = [5, 0, 31]
    img = pixels(rng, (3,) + plane_shape(nv, nh, pad, pad), "low contrast")
    got = loopfilter_cuda.loop_filter_plane(
        torch.from_numpy(img), torch.from_numpy(coded),
        torch.tensor(limits, dtype=torch.int32), nv, nh, pad, pad).numpy()
    for g, limit in enumerate(limits):
        assert np.array_equal(
            got[g], _reference(img[g], coded[g], limit, nv, nh, pad)), g
    assert np.array_equal(got[1], img[1])
    assert not np.array_equal(got[0], img[0])


@pytest.mark.parametrize("name", ["density 0.6", "checkerboard",
                                  "vE beside vL", "density 1"])
def test_kl_one_launch_split(name):
    """For every fragment row r, the plain filter on the window of
    fragment rows r - 1 and r with two pre-filter rows above and below
    (nv = 2, or 1 for r = 0; pad_y 2) gives the whole plane's result on
    the rows KL's CTA r owns: y0 - 1 .. y0 + 6 (row 0's y0 - 1 is
    padding), and y0 + 7 for the last row."""
    nv, nh, pad_y, pad_x = 5, 6, 8, 16
    rng = np.random.default_rng(11)
    coded = patterns(nv, nh, rng)[name]
    img = pixels(rng, plane_shape(nv, nh, pad_y, pad_x), "low contrast")
    whole = loopfilter_cuda.loop_filter_plane(
        torch.from_numpy(img), torch.from_numpy(coded), 15, nv, nh, pad_y,
        pad_x).numpy()
    assert not np.array_equal(whole, img)
    for r in range(nv):
        y0 = pad_y + 8 * r
        top = max(r - 1, 0)
        rows = slice(pad_y + 8 * top - 2, y0 + 10)
        win = loopfilter_cuda.loop_filter_plane(
            torch.from_numpy(np.ascontiguousarray(img[rows])),
            torch.from_numpy(np.ascontiguousarray(coded[top:r + 1])), 15,
            r + 1 - top, nh, 2, pad_x).numpy()
        lo = y0 if r == 0 else y0 - 1
        hi = y0 + 8 if r == nv - 1 else y0 + 7
        off = rows.start
        assert np.array_equal(win[lo - off:hi - off], whole[lo:hi]), r
