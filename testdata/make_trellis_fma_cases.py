"""Generate vectors/trellis_fma_cases.npz: blocks whose trellis result
depends on where XLA fuses a multiply-add into the costs that take a
fractional lambda.

With adaptive quantization's per-block lambda scales the trellis lambda
is fractional, so lam * bits is inexact, and the JAX trellis
(theora_tpu/ops/transforms_jax.py:trellis_values) as XLA on the CPU
compiles it in the encoder's scan fuses the lone and the next-lower
value's costs as fma(lam, bits, e * e) and the EOB cost as fma(lam,
bits, P[64] - P[i]). This script searches zig-zag DCT blocks (fDCTs of
random residuals, and coefficients over the int16 range) at random qi
and frame type with lambdas scaled by factors in [0.1, 8], and keeps,
for each of the three costs, up to 30 blocks where the port's trellis
(theora_tpu_torch/ops/transforms.py) gives another result when the cost
is formed the other way (fma(e, e, lam * bits), or two roundings).
tests/test_torch_encode_ops.py holds the port against the JAX trellis in
that scan on them, and chip_smoke.py kernel KT.

    python testdata/make_trellis_fma_cases.py
"""
from __future__ import annotations

import inspect
import os
import sys
import types

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from theora_tpu_torch import tables  # noqa: E402
from theora_tpu_torch.encode.gop import trellis_bit_costs  # noqa: E402
from theora_tpu_torch.ops import transforms  # noqa: E402
from theora_tpu_torch.quant import dequant_tables_init  # noqa: E402

# The three fused costs and the other way to form each.
ALTERNATES = {
    "lone value": ("cA_s = _fma(lamv, nbA, eA * eA)",
                   "cA_s = _fma(eA, eA, lamv * nbA)"),
    "next-lower value": ("cB_s = _fma(lamv, nbB, eB * eB)",
                         "cB_s = _fma(eB, eB, lamv * nbB)"),
    "EOB": ("costc_s = _fma(lam[:, None].expand(N, 64),",
            "costc_s = (lambda a, b, c: c + a * b)("
            "lam[:, None].expand(N, 64),"),
}


def _variant(old: str, new: str):
    """transforms.trellis_values with one expression replaced."""
    src = inspect.getsource(transforms)
    assert src.count(old) == 1, old
    mod = types.ModuleType("trellis_variant")
    exec(compile(src.replace(old, new), "trellis_variant", "exec"),
         mod.__dict__)
    return mod.trellis_values


def main() -> None:
    dq = dequant_tables_init(tables.DEF_QUANT_INFO)
    nb = torch.from_numpy(trellis_bit_costs(tables.VP31_HUFF_CODES))
    rng = np.random.default_rng(7)
    n = 20000
    found = {what: [] for what in ALTERNATES}
    variants = {what: _variant(*alt) for what, alt in ALTERNATES.items()}
    cases = []
    for it in range(8):
        if it % 2 == 0:  # encoder-like: fDCTs of random residuals
            res = (rng.integers(-255, 256, (n, 8, 8))
                   // rng.integers(1, 40, (n, 1, 1)))
            dct = transforms.fdct8x8(torch.from_numpy(res.astype(np.int32)))
        else:  # coefficients over the int16 range
            dct = torch.from_numpy(
                rng.integers(-32768, 32768, (n, 64)).astype(np.int32))
        qi = rng.integers(0, 64, n)
        qti = rng.integers(0, 2, n)
        deq = torch.from_numpy(dq[qi, 0, qti].astype(np.int32))
        lam = (np.array([tables.RD_LAMBDA[0][t][i]
                         for t, i in zip(qti, qi)], np.float32)
               * rng.uniform(0.1, 8.0, n).astype(np.float32))
        args = (dct, transforms.quantize(dct, deq), deq,
                torch.from_numpy(lam), nb,
                torch.from_numpy(np.where(qti == 0, 3, 0).astype(np.int32)))
        base = transforms.trellis_values(*args)
        for what, fn in variants.items():
            hits = np.where((fn(*args) != base).any(1).numpy())[0]
            for k in hits[:30 - len(found[what])]:
                found[what].append(len(cases))
                cases.append((dct[k].numpy(), qi[k], qti[k], lam[k]))
        print(f"pass {it}: " + ", ".join(
            f"{what} {len(v)}" for what, v in found.items()))
    np.savez_compressed(
        os.path.join(HERE, "vectors", "trellis_fma_cases.npz"),
        dct=np.array([c[0] for c in cases], np.int16),
        qi=np.array([c[1] for c in cases], np.uint8),
        qti=np.array([c[2] for c in cases], np.uint8),
        lam=np.array([c[3] for c in cases], np.float32))
    print(f"{len(cases)} blocks")


if __name__ == "__main__":
    main()
