# Frozen copy of theora_tpu_torch/quant.py at commit 6cd77e7, imports made relative;
# part of the benchmark's reference decoder, which imports nothing of the port;
# only the unpack and the dequant tables are kept.
"""Quantization parameters: setup-header unpack and pack, and dequant
tables.

Copy of theora_tpu/quant.py (`quant_params_unpack`, dequant.c:24-144;
`quant_params_pack`, enquant.c:85-182; `dequant_tables_init`,
quant.c:48-127).
"""
from __future__ import annotations

import numpy as np

from .bitio import BitReader
from .constants import ZIGZAG_TO_NAT, ilog

QUANT_MAX = 1024 << 2
# Minimum quantizers keep |quantized coeff| <= 510 (quant.c:24-33).
DC_QUANT_MIN = (4 << 2, 8 << 2)
AC_QUANT_MIN = (2 << 2, 4 << 2)


def quant_params_unpack(br: BitReader) -> dict:
    """Parse quantization parameters from a setup header
    (dequant.c:24-144)."""
    nbits = br.read(3)
    loop_filter_limits = [br.read(nbits) for _ in range(64)]
    nbits = br.read(4) + 1
    ac_scale = [br.read(nbits) for _ in range(64)]
    nbits = br.read(4) + 1
    dc_scale = [br.read(nbits) for _ in range(64)]
    nbase_mats = br.read(9) + 1
    base_mats = [[br.read(8) for _ in range(64)] for _ in range(nbase_mats)]
    nbits = ilog(nbase_mats - 1)
    qi_ranges: list[list[dict]] = [[None] * 3 for _ in range(2)]
    for i in range(6):
        qti, pli = divmod(i, 3)
        if i > 0:
            if not br.read1():
                # Reuse a previous range set (dequant.c:74-96).
                if qti > 0 and br.read1():
                    qtj, plj = qti - 1, pli
                else:
                    qtj, plj = divmod(i - 1, 3)
                qi_ranges[qti][pli] = qi_ranges[qtj][plj]
                continue
        indices = [br.read(nbits)]
        sizes = []
        qi = 0
        while qi < 63:
            size = br.read(ilog(62 - qi)) + 1
            sizes.append(size)
            qi += size
            indices.append(br.read(nbits))
        if qi > 63:
            raise ValueError("bad qi range partition")
        for bmi in indices:
            if bmi >= nbase_mats:
                raise ValueError("base matrix index out of range")
        qi_ranges[qti][pli] = {
            "sizes": sizes,
            "base_matrices": [list(base_mats[bmi]) for bmi in indices],
        }
    return {
        "loop_filter_limits": loop_filter_limits,
        "ac_scale": ac_scale,
        "dc_scale": dc_scale,
        "qi_ranges": qi_ranges,
    }


def dequant_tables_init(qinfo: dict) -> np.ndarray:
    """Dequantization tables: uint16 [64 qi][3 pli][2 qti][64], indexed
    by zig-zag coefficient position (quant.c:48-127)."""
    out = np.zeros((64, 3, 2, 64), dtype=np.uint16)
    fzig = ZIGZAG_TO_NAT
    dc_scale = np.asarray(qinfo["dc_scale"], dtype=np.uint32)
    ac_scale = np.asarray(qinfo["ac_scale"], dtype=np.uint32)
    for qti in range(2):
        for pli in range(3):
            ranges = qinfo["qi_ranges"][qti][pli]
            sizes = ranges["sizes"]
            mats = [np.asarray(m, dtype=np.uint32)
                    for m in ranges["base_matrices"]]
            qi = 0
            for qri in range(len(sizes) + 1):
                base = mats[qri].copy()
                qi_start = qi
                qi_end = qi + (sizes[qri] if qri < len(sizes) else 1)
                while True:
                    qfac = dc_scale[qi] * base[0]
                    q = (qfac // 100) << 2
                    q = min(max(DC_QUANT_MIN[qti], q), QUANT_MAX)
                    out[qi, pli, qti, 0] = q
                    qac = (ac_scale[qi] * base[fzig[1:]] // 100) << 2
                    qac = np.clip(qac, AC_QUANT_MIN[qti], QUANT_MAX)
                    out[qi, pli, qti, 1:] = qac
                    qi += 1
                    if qi >= qi_end:
                        break
                    # Interpolate the next base matrix (quant.c:117-123).
                    sz = sizes[qri]
                    base = (
                        2 * ((qi_end - qi) * mats[qri]
                             + (qi - qi_start) * mats[qri + 1])
                        + sz
                    ) // (2 * sz)
    return out


