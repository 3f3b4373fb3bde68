"""The port's transforms and kernel K1's plain version against the JAX
twins, the Pallas kernel (interpret mode) and libtheora's iDCT vectors.
Integer codec: every comparison is exact."""
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tests.conftest import TESTDATA
from theora_tpu.constants import ZIGZAG_TO_NAT
from theora_tpu.ops import pallas_kernels as pk
from theora_tpu.ops import transforms_jax as tj
from theora_tpu_torch.ops import idct_cuda
from theora_tpu_torch.ops import transforms as tt

# The tests run in several worker processes on a few CPUs: one torch
# thread each (their tensors are small, and idle intra-op threads spin).
torch.set_num_threads(1)

_REC = np.dtype([("x", "<i2", 64), ("zzi", "<i4"), ("y", "<i2", 64)])


def _k1_case(seed, n=700, nframes=3):
    """Random K1 inputs over the whole int16 range (wrap extremes), with
    per-block frame / qii / inter / dc_only."""
    rng = np.random.default_rng(seed)
    qz = rng.integers(-32768, 32768, (n, 64), dtype=np.int16)
    qz[:8] = np.array([-32768, 32767], np.int16)[rng.integers(0, 2, (8, 64))]
    dc = rng.integers(-32768, 32768, n, dtype=np.int16)
    tab = rng.integers(1, 4097, (nframes, 3, 2, 64)).astype(np.int16)
    tab[0, 0, 0] = 32767
    frame = np.sort(rng.integers(0, nframes, n)).astype(np.int32)
    qii = rng.integers(0, 3, n).astype(np.uint8)
    inter = rng.integers(0, 2, n).astype(np.uint8)
    dc_only = rng.random(n) < 0.3
    return qz, dc, tab, frame, qii, inter, dc_only


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("lo,hi", [(-8100, 8101), (-32768, 32768)])
def test_idct8x8_matches_jax(lo, hi):
    rng = np.random.default_rng(3)
    x = rng.integers(lo, hi, size=(300, 8, 8)).astype(np.int32)
    ref = np.asarray(jax.jit(tj.idct8x8)(jnp.asarray(x)))
    out = tt.idct8x8(torch.from_numpy(x)).numpy()
    assert np.array_equal(out, ref)


def test_dc_fill_matches_jax():
    rng = np.random.default_rng(6)
    dc = rng.integers(-32768, 32768, size=(200,)).astype(np.int32)
    q = rng.integers(1, 32768, size=(200,)).astype(np.int32)
    ref = np.asarray(tj.dc_fill(jnp.asarray(dc), jnp.asarray(q)))
    out = tt.dc_fill(torch.from_numpy(dc), torch.from_numpy(q)).numpy()
    assert np.array_equal(out, ref)


def test_dequantize_idct_matches_jax():
    """Per-block dequant rows, DC-only blocks and int16 wrap extremes."""
    qz, dc, tab, frame, qii, inter, dc_only = _k1_case(11)
    rows = tab[frame, qii, inter].astype(np.int32)
    dcq = tab[frame, 0, inter, 0].astype(np.int32)
    args = (qz.astype(np.int32), rows, dc.astype(np.int32), dcq, dc_only)
    ref = np.asarray(tj.dequantize_idct(*map(jnp.asarray, args)))
    out = tt.dequantize_idct(*_torch(*args)).numpy()
    assert np.array_equal(out, ref)


@pytest.mark.parametrize("seed", [5, 6])
def test_k1_plain_matches_pallas_decode_step(seed):
    """dequantize_idct_frames (K1's plain version, the wrapper's CPU
    path) equals the JAX decode scan's Pallas branch
    (decode/tpu_batch.py:92-106) with idct8x8_soa in interpret mode."""
    qz, dc, tab, frame, qii, inter, dc_only = _k1_case(seed)
    deqf = jnp.asarray(tab[frame, qii, inter].astype(np.int32))
    dcqf = jnp.asarray(tab[frame, 0, inter, 0].astype(np.int32))
    dcf = jnp.asarray(dc.astype(np.int32))
    deq = tj._i16(jnp.asarray(qz.astype(np.int32)) * deqf)
    deq = deq.at[:, 0].set(tj._i16(dcf * dcqf))
    nat = jnp.zeros_like(deq).at[:, tj._ZZ].set(deq)
    full = pk.soa_to_blocks(pk.idct8x8_soa(nat.T, interpret=True))
    ref = np.asarray(
        jnp.where(jnp.asarray(dc_only)[:, None, None],
                  tj.dc_fill(dcf, dcqf), full)
    ).reshape(-1, 64)
    before = idct_cuda.dequantize_idct_frames.launches
    out = idct_cuda.dequantize_idct_frames(
        *_torch(qz, dc, tab, frame, qii, inter, dc_only))
    assert idct_cuda.dequantize_idct_frames.launches == before
    assert out.dtype == torch.int16
    assert np.array_equal(out.numpy().astype(np.int32), ref)


def _vector_case():
    raw = open(os.path.join(TESTDATA, "vectors", "idct_cases.bin"), "rb").read()
    cases = np.frombuffer(raw, dtype=_REC)
    return cases["x"].astype(np.int16), cases["y"].astype(np.int16)


def test_idct_vectors_through_port():
    x, y = _vector_case()
    out = tt.idct8x8(torch.from_numpy(x.reshape(-1, 8, 8).astype(np.int32)))
    assert np.array_equal(out.reshape(-1, 64).numpy(), y)
    n = len(x)
    out = idct_cuda.dequantize_idct_frames(*_torch(
        x[:, ZIGZAG_TO_NAT[:64]], x[:, 0], np.ones((1, 3, 2, 64), np.int16),
        np.zeros(n, np.int32), np.zeros(n, np.uint8), np.zeros(n, np.uint8),
        np.zeros(n, bool),
    ))
    assert np.array_equal(out.numpy(), y)
