"""Probe which fused multiply-adds XLA forms in the JAX trellis in two
compile contexts (ROADMAP.md §3 fault F4).

The JAX encoder runs theora_tpu/ops/transforms_jax.py:trellis_values
inside its plane scan, with lam = lam_t * lam_sc computed from the scan's
per-step inputs (theora_tpu/encode/tpu_gop.py:226-229). On the CPU, XLA
lets LLVM contract a*b + c into one fused multiply-add, and which product
of a sum of two products it fuses depends on the compiled context. This
script runs the JAX trellis in such a scan and in jax.jit(trellis_values)
alone, beside the port's plain trellis
(theora_tpu_torch/ops/transforms.py) with each placement of the three
costs that take a lambda: the lone value's, the next-lower value's and
the EOB's, as fma(e, e, lam * bits), fma(lam, bits, e * e) or two
roundings. It prints, per placement, the blocks that differ from each
context. KIND picks the inputs: "frac" (the default) the fDCTs of random
residuals (bench_fdct.random_residuals) with lambdas scaled by factors in
[0.1, 8], "int" the same blocks at the integer table lambdas, "int16"
coefficients over the int16 range at scaled lambdas; qi and frame type
are random. Run from the repository root (JAX on the CPU):

    python testdata/probe_trellis_fma_context.py [SEED] [BATCHES] [KIND]

With seed 1 and 8 batches of 2,000 blocks, the port's placement (the
first line printed) differs from the scan in 0 blocks of each kind, and
from the standalone jit in 4 ("frac") and 0 ("int", "int16"); the lone
value's cost as fma(e, e, lam * bits) differs from the scan in 4 blocks
("frac") and from the standalone jit in 0.
"""
from __future__ import annotations

import inspect
import itertools
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
from theora_tpu_torch.tools import bench_fdct  # noqa: E402

BLOCKS = 2000
# Each cost's placements; the first of each is the port's.
LONE = {"fma(l,b,ee)": "cA_s = _fma(lamv, nbA, eA * eA)",
        "fma(e,e,lb)": "cA_s = _fma(eA, eA, lamv * nbA)",
        "two roundings": "cA_s = (eA * eA) + (lamv * nbA)"}
LOWER = {"fma(l,b,ee)": "cB_s = _fma(lamv, nbB, eB * eB)",
         "fma(e,e,lb)": "cB_s = _fma(eB, eB, lamv * nbB)",
         "two roundings": "cB_s = (eB * eB) + (lamv * nbB)"}
EOB = {"fma(l,b,D)": "costc_s = _fma(lam[:, None].expand(N, 64),",
       "two roundings": "costc_s = (lambda a, b, c: c + a * b)("
                        "lam[:, None].expand(N, 64),"}


def _variants() -> dict:
    """{(lone, lower, eob): the port's trellis_values with those
    placements}."""
    src = inspect.getsource(transforms)
    out = {}
    for (ka, va), (kb, vb), (kc, vc) in itertools.product(
            LONE.items(), LOWER.items(), EOB.items()):
        s = (src.replace(LONE["fma(l,b,ee)"], va)
             .replace(LOWER["fma(l,b,ee)"], vb)
             .replace(EOB["fma(l,b,D)"], vc))
        mod = types.ModuleType("trellis_variant")
        exec(compile(s, "trellis_variant", "exec"), mod.__dict__)
        out[(ka, kb, kc)] = mod.trellis_values
    return out


def main(seed: int = 1, batches: int = 8, kind: str = "frac") -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    from theora_tpu.ops import transforms_jax as tj

    def scanned(dct, q, deq, lts, lss, nb, acmin):
        def step(carry, x):
            lt, ls = x
            return carry, tj.trellis_values(dct, q, deq, lt * ls, nb, acmin)
        return jax.lax.scan(step, 0, (lts, lss))[1][0]

    in_scan = jax.jit(scanned)
    alone = jax.jit(tj.trellis_values)
    dq = dequant_tables_init(tables.DEF_QUANT_INFO)
    nb = trellis_bit_costs(tables.VP31_HUFF_CODES)
    variants = _variants()
    differ = {k: [0, 0] for k in variants}
    rng = np.random.default_rng(seed)
    for b in range(batches):
        qi, qti = int(rng.integers(0, 64)), int(rng.integers(0, 2))
        deq = np.broadcast_to(dq[qi, 0, qti].astype(np.int32), (BLOCKS, 64))
        if kind == "int16":
            dct = torch.from_numpy(
                rng.integers(-32768, 32768, (BLOCKS, 64)).astype(np.int32))
        else:
            res = torch.from_numpy(bench_fdct.random_residuals(rng, BLOCKS))
            dct = transforms.fdct8x8(res.reshape(-1, 8, 8))
        q = transforms.quantize(dct, torch.from_numpy(deq.copy()))
        lt = np.full(BLOCKS, tables.RD_LAMBDA[0][qti][qi], np.float32)
        ls = (np.ones(BLOCKS, np.float32) if kind == "int" else
              rng.uniform(0.1, 8.0, BLOCKS).astype(np.float32))
        acmin = np.full(BLOCKS, 0 if qti else 3, np.int32)
        args = (dct.numpy().astype(np.int32), q.numpy().astype(np.int32),
                np.ascontiguousarray(deq))
        ref_scan = np.asarray(in_scan(*args, np.stack([lt, lt]),
                                      np.stack([ls, ls]), nb, acmin))
        ref_alone = np.asarray(alone(*args, lt * ls, nb, acmin))
        targs = [torch.from_numpy(a) for a in args] + [
            torch.from_numpy(lt * ls), torch.from_numpy(nb),
            torch.from_numpy(acmin)]
        for k, fn in variants.items():
            got = fn(*targs).numpy()
            differ[k][0] += int((got != ref_scan).any(axis=1).sum())
            differ[k][1] += int((got != ref_alone).any(axis=1).sum())
    print(f"{batches * BLOCKS} blocks ({kind}); (lone value, next-lower value, EOB): "
          f"blocks differing from the scan, from jit(trellis_values)")
    for k, (s, a) in sorted(differ.items(), key=lambda kv: kv[1]):
        print(f"  {k}: {s}, {a}")


if __name__ == "__main__":
    main(*[int(a) for a in sys.argv[1:3]], *sys.argv[3:4])
