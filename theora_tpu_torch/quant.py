"""Quantization parameters: setup-header unpack and pack, and dequant
tables.

Copy of theora_tpu/quant.py (`quant_params_unpack`, dequant.c:24-144;
`quant_params_pack`, enquant.c:85-182; `dequant_tables_init`,
quant.c:48-127).
"""
from __future__ import annotations

import numpy as np

from theora_tpu_torch.bitio import BitReader, BitWriter
from theora_tpu_torch.constants import ZIGZAG_TO_NAT, ilog

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


def quant_params_pack(bw: BitWriter, qinfo: dict) -> None:
    """Emit quantization parameters into a setup header, with base-matrix
    deduplication (oc_quant_params_pack, enquant.c:85-182)."""
    lfl = qinfo["loop_filter_limits"]
    nbits = max(ilog(v) for v in lfl)
    bw.write(nbits, 3)
    for v in lfl:
        bw.write(v, nbits)
    for key in ("ac_scale", "dc_scale"):
        vals = qinfo[key]
        nbits = max(max(ilog(v) for v in vals), 1)
        bw.write(nbits - 1, 4)
        for v in vals:
            bw.write(v, nbits)
    range_sets = [qinfo["qi_ranges"][qti][pli]
                  for qti, pli in (divmod(i, 3) for i in range(6))]
    # Unique base matrices in first-use order over the range sets that are
    # not packed as references to an earlier set.
    base_mats: list[tuple] = []
    mat_index: dict[tuple, int] = {}
    for i in range(6):
        if _dup_of(range_sets, i) >= 0:
            continue
        for m in range_sets[i]["base_matrices"]:
            key = tuple(m)
            if key not in mat_index:
                mat_index[key] = len(base_mats)
                base_mats.append(key)
    bw.write(len(base_mats) - 1, 9)
    for m in base_mats:
        for v in m:
            bw.write(v, 8)
    nbits = ilog(len(base_mats) - 1)
    for i in range(6):
        qti = i // 3
        dup = _dup_of(range_sets, i)
        if i > 0:
            if dup >= 0:
                bw.write(0, 1)
                if qti > 0:
                    # 1: same plane of the previous qti; 0: previous set.
                    if dup != i - 3 and dup != i - 1:
                        raise ValueError("unsupported range-set reuse")
                    bw.write(1 if dup == i - 3 else 0, 1)
                continue
            bw.write(1, 1)
        rs = range_sets[i]
        bw.write(mat_index[tuple(rs["base_matrices"][0])], nbits)
        qi = 0
        for ri, size in enumerate(rs["sizes"]):
            bw.write(size - 1, ilog(62 - qi))
            qi += size
            bw.write(mat_index[tuple(rs["base_matrices"][ri + 1])], nbits)
        if qi != 63:
            raise ValueError("qi ranges must cover 0..63")


def _dup_of(range_sets: list, i: int) -> int:
    """Index j (i-3 or i-1) of an earlier range set equal to set i, else
    -1: the bitstream can only reference those two (dequant.c:74-96)."""
    if i == 0:
        return -1

    def eq(a, b):
        return (a["sizes"] == b["sizes"]
                and a["base_matrices"] == b["base_matrices"])

    if i >= 3 and eq(range_sets[i], range_sets[i - 3]):
        return i - 3
    if eq(range_sets[i], range_sets[i - 1]):
        return i - 1
    return -1


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


def pp_dc_scale_init(qinfo: dict) -> np.ndarray:
    """The postprocessor's DC scale per qi, [64] int32 (quant.c:86-87).

    The reference writes the slot in every (qti, pli) walk of the qi
    ranges; each walk covers qi 0..63, so the last walk's values stand
    (the copy of theora_tpu/quant.py:pp_dc_scale_init walks all six)."""
    out = np.zeros(64, dtype=np.int32)
    dc_scale = np.asarray(qinfo["dc_scale"], dtype=np.uint32)
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
                    out[qi] = int(dc_scale[qi] * base[0]) // 160
                    qi += 1
                    if qi >= qi_end:
                        break
                    sz = sizes[qri]
                    base = (
                        2 * ((qi_end - qi) * mats[qri]
                             + (qi - qi_start) * mats[qri + 1])
                        + sz
                    ) // (2 * sz)
    return out


def pp_sharp_mod(dequant: np.ndarray) -> np.ndarray:
    """The postprocessor's sharpening weight per qi, [64] int32, from the
    dequant tables [64, 3, 2, 64] (decode.c:399-409; the copy of
    theora_tpu/decode/decoder.py:192-203)."""
    d = dequant.astype(np.int64)
    taps = d[..., 12] + d[..., 17] + d[..., 18] + d[..., 24]  # [64, 3, 2]
    taps[:, 0] <<= 1  # luma counts twice
    return (-(taps.sum(axis=(1, 2)) >> 11)).astype(np.int32)
