"""Generate vectors/qrd_fma_cases.npz: blocks whose R/D quantizer result
depends on where XLA fuses a multiply-add.

The JAX R/D quantizer (theora_tpu/ops/transforms_jax.py:quantize_rd), as
XLA on the CPU compiles it, forms the magnitude test's costs err + lam *
bits as fma(lam, bits, err) on both sides, and the kill sweeps' gain
av * av - err_coded as fma(av, av, -err_coded). This script builds
blocks near a tie of each decision and keeps those where the port's R/D
quantizer (theora_tpu_torch/ops/transforms.py:quantize_rd_values) gives
another result when one expression is formed another way (two
roundings, or the other product fused), up to 4 blocks per way and
dequant row of each kind:

- the magnitude test at the encoder's own dequant rows (qi 20, 40 and 63,
  luma and chroma, both frame types), one value of magnitude 3, 5, 7 or
  8, with lambdas within a few ulps of a tie (with these rows every
  square is exact, so only lam * bits rounds);
- the magnitude test and the isolated and tail sweeps at dequant values
  of 3,000-16,000, where the squares round.

Each block has its own dequant row and lambda; blocks of one (row,
lambda) pair can share a launch of kernel KR. Every kept block is checked
against the JAX quantizer here. tests/test_torch_speed.py holds the port
against JAX on them and shows that each other way fails on some;
chip_smoke.py holds kernel KR against the plain version on them.

    python testdata/make_qrd_fma_cases.py
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
from theora_tpu_torch.ops import transforms  # noqa: E402
from theora_tpu_torch.quant import dequant_tables_init  # noqa: E402

MAG = "take1 = _fma(lamc.expand_as(d), bits1, t1 * t1) <= _fma(\n" \
      "        lamc.expand_as(d), bits0, t0 * t0)"
GAIN = "gain = _fma(av, av, -(tc * tc))"
TAIL = "_fma(v_at, v_at, -(t_at * t_at))"
# The other ways to form each fused expression.
ALTERNATES = {
    "magnitude, two roundings": (
        MAG, "take1 = t1 * t1 + lamc * bits1 <= t0 * t0 + lamc * bits0"),
    "magnitude, err fused": (
        MAG, "take1 = _fma(t1, t1, lamc * bits1) <= _fma(\n"
             "        t0, t0, lamc * bits0)"),
    "isolated gain, two roundings": (GAIN, "gain = av * av - tc * tc"),
    "isolated gain, err fused": (GAIN, "gain = _fma(-tc, tc, av * av)"),
    "tail gain, two roundings": (TAIL, "(v_at * v_at - t_at * t_at)"),
    "tail gain, err fused": (TAIL, "_fma(-t_at, t_at, v_at * v_at)"),
}
PER_ROW = 4
MAG_BITS = np.array([0.0, 4.5, 5.5, 6.5, 6.5, 7.5, 7.5, 8.5, 9.5],
                    np.float32)


def variant(old: str, new: str):
    """transforms.quantize_rd_values with one expression replaced."""
    src = inspect.getsource(transforms)
    assert src.count(old) == 1, old
    mod = types.ModuleType("qrd_variant")
    exec(compile(src.replace(old, new), "qrd_variant", "exec"),
         mod.__dict__)
    return mod.quantize_rd_values


def _ulps(lam: float, k: int) -> np.float32:
    x = np.float32(lam)
    for _ in range(abs(k)):
        x = np.nextafter(x, np.float32(np.inf if k > 0 else 0.0))
    return x


def magnitude_candidates(rng, row: np.ndarray):
    """(dct, lam) blocks near a tie of the magnitude test at one dequant
    row: one value of magnitude 3, 5, 7 or 8 at one position, its lambda
    within 3 ulps of the tie."""
    out = []
    for _ in range(3000):
        p = int(rng.integers(1, 64))
        d = int(row[p])
        a0 = int(rng.choice([3, 5, 7, 8]))
        av = min(int(rng.integers(a0 * d - d // 2, a0 * d + (d + 1) // 2)),
                 32767)
        e0 = (a0 * d - av) ** 2
        e1 = ((a0 - 1) * d - av) ** 2
        db = float(MAG_BITS[min(a0, 8)] - MAG_BITS[a0 - 1])
        if e1 <= e0:
            continue
        blk = np.zeros(64, np.int32)
        blk[p] = av * int(rng.choice([-1, 1]))
        out.append((blk, _ulps((e1 - e0) / db, int(rng.integers(-3, 4)))))
    return out


def kill_candidates(rng, row: np.ndarray, bits: float, tail: bool):
    """(dct, lam) blocks near a tie of a kill sweep's gain at one dequant
    row of large values: a value of magnitude 1 at one position, isolated
    (a later value of magnitude 20 two positions on, where there is room)
    or last with a nonzero left neighbour."""
    out = []
    for _ in range(3000):
        p = int(rng.integers(2, 63))
        d = int(row[p])
        av = int(rng.integers(d - d // 2, min(d + d // 2, 32768)))
        gain = np.float32(av) * np.float32(av) - np.float32(d - av) ** 2
        if gain <= 0:
            continue
        blk = np.zeros(64, np.int32)
        blk[p] = av * int(rng.choice([-1, 1]))
        if tail:
            blk[p - 1] = 20 * int(row[p - 1])
        elif p + 2 < 64:
            blk[p + 2] = 20 * int(row[p + 2])
        out.append((blk, _ulps(float(gain) / bits,
                               int(rng.integers(-6, 7)))))
    return out


def main() -> None:
    dq = dequant_tables_init(tables.DEF_QUANT_INFO)
    rng = np.random.default_rng(8)
    variants = {what: variant(*alt) for what, alt in ALTERNATES.items()}
    base = transforms.quantize_rd_values
    found = {what: 0 for what in ALTERNATES}
    keep = []  # (dct, deq row, lam)

    def scan(cands, row):
        kept = {what: 0 for what in ALTERNATES}
        dct = torch.from_numpy(np.stack([c[0] for c in cands]))
        lam = torch.from_numpy(np.array([c[1] for c in cands], np.float32))
        deq = torch.from_numpy(np.tile(row.astype(np.int32), (len(dct), 1)))
        q0 = transforms.quantize(dct, deq)
        ref = base(q0, dct, deq, lam)
        hit = torch.zeros(len(dct), dtype=torch.bool)
        for what, fn in variants.items():
            diff = (fn(q0, dct, deq, lam) != ref).any(dim=1) & ~hit
            for k in torch.nonzero(diff).reshape(-1).tolist():
                if kept[what] >= PER_ROW:
                    break
                kept[what] += 1
                found[what] += 1
                hit[k] = True
                keep.append((cands[k][0], row, cands[k][1]))

    for qi in (20, 40, 63):
        for pli in (0, 1):
            for qti in (0, 1):
                scan(magnitude_candidates(rng, dq[qi, pli, qti]),
                     dq[qi, pli, qti])
    for it in range(6):
        row = np.concatenate([[16], rng.integers(3000, 16000, 63)])
        scan(magnitude_candidates(rng, row), row)
        scan(kill_candidates(rng, row, 11.0, False), row)
        scan(kill_candidates(rng, row, 14.0, True), row)
        print(f"pass {it}: " + ", ".join(f"{w} {n}"
                                         for w, n in found.items()))
    dct = np.array([c[0] for c in keep], np.int16)
    deq = np.array([c[1] for c in keep], np.int16)
    lam = np.array([c[2] for c in keep], np.float32)

    import jax

    jax.config.update("jax_platforms", "cpu")
    from theora_tpu.ops import transforms_jax as tj

    ref = np.asarray(jax.jit(tj.quantize_rd)(dct.astype(np.int32),
                                             deq.astype(np.int32), lam))
    got = transforms.quantize_rd(torch.from_numpy(dct.astype(np.int32)),
                                 torch.from_numpy(deq.astype(np.int32)),
                                 torch.from_numpy(lam)).numpy()
    assert np.array_equal(ref, got), "the port differs from JAX"
    np.savez_compressed(os.path.join(HERE, "vectors", "qrd_fma_cases.npz"),
                        dct=dct, deq=deq, lam=lam)
    print(f"{len(dct)} blocks, {len(np.unique(deq, axis=0))} dequant rows")


if __name__ == "__main__":
    main()
