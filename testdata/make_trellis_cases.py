"""Generate vectors/trellis_order_cases.npz: blocks whose trellis result
depends on the order of the float32 prefix sum of c^2.

The JAX trellis (theora_tpu/ops/transforms_jax.py:trellis_values) takes
that prefix sum with jnp.cumsum, which XLA on the CPU evaluates in chunks
of 16 positions; a sequential sum rounds differently. This script
searches random zig-zag DCT blocks (uniform over the int16 range,
sparse, and Gaussian) at random qi and frame type, and keeps the blocks
where the port's trellis (theora_tpu_torch/ops/transforms.py) gives
another result when its prefix sum is made sequential. tests/
test_torch_encode_ops.py holds the port against the JAX trellis on them.

    python testdata/make_trellis_cases.py
"""
from __future__ import annotations

import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from theora_tpu_torch import tables  # noqa: E402
from theora_tpu_torch.constants import DCT_TOKEN_EXTRA_BITS, \
    ZZI_GROUP  # noqa: E402
from theora_tpu_torch.ops import transforms  # noqa: E402
from theora_tpu_torch.quant import dequant_tables_init  # noqa: E402


def sequential_cumsum(z: torch.Tensor) -> torch.Tensor:
    out = z.clone()
    for j in range(1, z.shape[1]):
        out[:, j] = out[:, j - 1] + out[:, j]
    return out


def main() -> None:
    dq = dequant_tables_init(tables.DEF_QUANT_INFO)
    nbt = np.zeros((5, 32), np.float32)
    for gi in range(5):
        for t in range(32):
            nbt[gi, t] = (tables.VP31_HUFF_CODES[gi << 4][t][1]
                          + DCT_TOKEN_EXTRA_BITS[t])
    nb = torch.from_numpy(nbt[ZZI_GROUP])
    rng = np.random.default_rng(5)
    found = []
    for it in range(6):
        n = 50000
        mode = it % 3
        if mode == 0:
            dct = rng.integers(-32768, 32768, (n, 64))
        elif mode == 1:
            dct = (rng.integers(-32768, 32768, (n, 64))
                   * (rng.random((n, 64)) < 0.3))
        else:
            dct = np.round(rng.standard_normal((n, 64))
                           * rng.uniform(100, 20000, (n, 1))
                           ).clip(-32768, 32767)
        dct = dct.astype(np.int32)
        qi = rng.integers(0, 64, n)
        qti = rng.integers(0, 2, n)
        deq = torch.from_numpy(dq[qi, 0, qti].astype(np.int32))
        d = torch.from_numpy(dct)
        q0 = transforms.quantize(d, deq)
        lam = torch.tensor([tables.RD_LAMBDA[0][t][i]
                            for t, i in zip(qti, qi)], dtype=torch.float32)
        acmin = torch.from_numpy(np.where(qti == 0, 3, 0).astype(np.int32))
        args = (d, q0, deq, lam, nb, acmin)
        base = transforms.trellis_values(*args)
        chunked = transforms._xla_cumsum16
        transforms._xla_cumsum16 = sequential_cumsum
        try:
            alt = transforms.trellis_values(*args)
        finally:
            transforms._xla_cumsum16 = chunked
        for k in np.where((alt != base).any(1).numpy())[0][:50]:
            found.append((dct[k], qi[k], qti[k]))
    np.savez_compressed(
        os.path.join(HERE, "vectors", "trellis_order_cases.npz"),
        dct=np.array([f[0] for f in found], np.int16),
        qi=np.array([f[1] for f in found], np.uint8),
        qti=np.array([f[2] for f in found], np.uint8))
    print(f"{len(found)} blocks")


if __name__ == "__main__":
    main()
