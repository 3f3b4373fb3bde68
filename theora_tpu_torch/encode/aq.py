"""Adaptive quantization's host gates: the frame's qi list and the luma
blocks' chooser lambda scales.

Port of the gates the JAX device encoder runs on the host before its
plane scans: theora_tpu/encode/encoder.py `Encoder._adaptive_qi_triple`
(with its `find_qi` tie rule), `_luma_activity` (the numpy form; equal to
the native `activity8_plane_native`), `_mixed_frame`, `_activity_iscale`
and `_noise_like`, and theora_tpu/encode/tpu_gop.py
`TpuGopEncoder._adaptive_qis` with the per-frame `frame_gates`
(tpu_gop.py:1041-1123). The encoder's vp3_compatible flag and speed levels
are not ported, so they stay at their defaults (off and 0).

Modes: False never engages; True engages wherever the reference's spec
allows it (log_qavg < 7); "auto", the default, only in the
quality-saturation region, on noise-like frames at mid q, and on spatially
mixed frames just above saturation (encoder.py:1012-1028).
"""
from __future__ import annotations

import numpy as np

from theora_tpu_torch.encode.qavg_tables import LOG_QAVG

MODES = (False, True, "auto")


def check_mode(mode):
    """The mode itself, or ValueError for anything but False, True and
    "auto"."""
    if not any(mode is m or (isinstance(m, str) and mode == m)
               for m in MODES):
        raise ValueError(f"adaptive_quant: expected False, True or 'auto', "
                         f"got {mode!r}")
    return mode


def _find_qi(lqa, target: float, qi_old: int) -> int:
    """The qi whose log_qavg is nearest target; ties go to the qi nearest
    qi_old, then to the lower qi."""
    best_qi, best_d = 0, abs(lqa[0] - target)
    for qi in range(1, 64):
        d = abs(lqa[qi] - target)
        if d < best_d or (d == best_d
                          and abs(qi - qi_old) < abs(best_qi - qi_old)):
            best_qi, best_d = qi, d
    return best_qi


def qi_triple(mode, base: int, qti: int, pixel_fmt: int,
              noise_like: bool = False, mixed: bool = False,
              has_lam_scale: bool = False):
    """The frame's (base, coarser, finer) qi list at frame type qti, or
    None where masking does not engage (encoder.py:964-1049). noise_like,
    mixed and has_lam_scale are the frame's gates (frame_gates)."""
    if not mode:
        return None
    lqa = LOG_QAVG.get(int(pixel_fmt), LOG_QAVG[0])[qti]
    lq = lqa[base]
    if lq >= 7.0:
        return None
    if mode == "auto" and lq >= (4.0 if qti == 0 else 4.8):
        mixed_window = (mixed and has_lam_scale
                        and lq < (4.7 if qti == 0 else 5.2))
        if not (noise_like or mixed_window):
            return None
    coarser = _find_qi(lqa, lq + 0.7, max(base - 1, 0))
    finer = _find_qi(lqa, lq - 0.6, min(base + 1, 63))
    qis = [base]
    if coarser != base:
        qis.append(coarser)
    if finer != base and finer != coarser:
        qis.append(finer)
    return qis if len(qis) >= 2 else None


def frame_qis(mode, base: int, pixel_fmt: int, keyframe_only: bool,
              noise_like: bool = False, mixed: bool = False,
              has_lam_scale: bool = False) -> tuple:
    """A frame's qi list (tpu_gop.py:582-607): (base,) unless masking
    engages. A frame whose GOP is only a keyframe takes the intra triple;
    every other frame, its GOP's keyframe included, the inter one."""
    qis = qi_triple(mode, base, 0 if keyframe_only else 1, pixel_fmt,
                    noise_like, mixed, has_lam_scale)
    return tuple(qis) if qis else (base,)


def luma_activity(y: np.ndarray) -> np.ndarray:
    """Per-8x8-block activity of a luma plane, 64 sum(c^2) - (sum c)^2,
    with the reference's flat clamp (analyze.c:1152-1197): below 8 << 12
    it is at most 5 << 12. int64, blocks in raster order."""
    h, w = y.shape
    b = (y.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3)
         .reshape(-1, 64).astype(np.int64))
    x = b.sum(axis=1)
    x2 = (b * b).sum(axis=1)
    act = (x2 << 6) - x * x
    flat = act < (8 << 12)
    act[flat] = np.minimum(act[flat], 5 << 12)
    return act


def mixed_frame(act: np.ndarray, spread_octaves: float = 4.0) -> bool:
    """Is the frame spatially heterogeneous: does the p90/p10 spread of
    the blocks' log2 activity exceed spread_octaves?"""
    la = np.log2(np.maximum(act.astype(np.float64), 1.0))
    p10, p90 = np.percentile(la, [10, 90])
    return bool(p90 - p10 > spread_octaves)


def activity_iscale(act: np.ndarray) -> np.ndarray:
    """Per-block lambda scale, the reference's rd_iscale analogue
    (analyze.c:1256-1340): ((4 act + avg) / (act + 4 avg)) ** 1.5 clipped
    to [0.1, 8], float64."""
    avg = float(np.mean(act))
    a = act.astype(np.float64)
    sc = (4.0 * a + avg) / (a + 4.0 * avg)
    return np.clip(sc ** 1.5, 0.1, 8.0)


def noise_like(y: np.ndarray, thresh: float = 0.10) -> bool:
    """Is the luma plane iid-noise-like: is the lag-1 horizontal
    autocorrelation of every fourth row below thresh?"""
    ys = y[::4].astype(np.float64)
    yc = ys - ys.mean()
    denom = float((yc * yc).sum())
    if denom < 1e-6:
        return False
    ac = float((yc[:, :-1] * yc[:, 1:]).sum()) / denom
    return ac < thresh


def frame_gates(y: np.ndarray, mode):
    """A frame's content gates from its luma plane in bitstream
    orientation (tpu_gop.py:1041-1069): (noise_like, mixed, the [n]
    float64 lambda scales of its luma blocks or None). The scales exist
    only on a mixed frame that is not noise-like."""
    nl = noise_like(y)
    act = luma_activity(y)
    mixed = mixed_frame(act)
    sc = activity_iscale(act) if (mixed and mode and not nl) else None
    return nl, mixed, sc
