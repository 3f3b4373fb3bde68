"""Decoder telemetry overlays: visual debugging of macroblock modes,
motion vectors, per-block quantizer choice, and per-fragment bit usage.

Port of theora_tpu/decode/telemetry.py, pixel for pixel: host numpy
work, drawn on the downloaded display-orientation frame, as the JAX
decoder draws it.

Capability-equivalent redesign of the reference's cairo-based renderer
(decode.c:2083-2460, behind TH_DECCTL_SET_TELEMETRY_{MBMODE,MV,QI,BITS}):
instead of RGB round-trips through a vector library, overlays are drawn
directly on the YCbCr planes with vectorized numpy, which keeps the
decoder dependency-free and the overlay cost trivial.

Legend (matching the spirit of the reference's palette):
  MBMODE  block borders tinted per coding mode (chroma); INTRA red,
          INTER_NOMV dark, INTER_MV/LAST/LAST2 green shades,
          GOLDEN blue shades, 4MV magenta. Uncoded blocks untinted.
  MV      luma line from block center along the half-pel vector.
  QI      chroma tint per qii (base none, +1 cool, +2 warm).
  BITS    per-fragment bit usage as a brightness bar along the block's
          bottom row (full width == 128 bits).
"""
from __future__ import annotations

import numpy as np

from theora_tpu_torch.constants import (
    MODE_GOLDEN_MV,
    MODE_GOLDEN_NOMV,
    MODE_INTER_MV,
    MODE_INTER_MV_FOUR,
    MODE_INTER_MV_LAST,
    MODE_INTER_MV_LAST2,
    MODE_INTER_NOMV,
    MODE_INTRA,
)

# Per-mode (Cb, Cr) border tints.
_MODE_TINT = {
    MODE_INTRA: (90, 240),            # red
    MODE_INTER_NOMV: (128, 128),      # neutral gray (drawn dark on luma)
    MODE_INTER_MV: (60, 60),          # green
    MODE_INTER_MV_LAST: (80, 80),
    MODE_INTER_MV_LAST2: (100, 100),
    MODE_GOLDEN_NOMV: (230, 110),     # blue
    MODE_GOLDEN_MV: (210, 120),
    MODE_INTER_MV_FOUR: (200, 220),   # magenta
}


def render_telemetry(geom, planes, state, mbmode=0, mv=0, qi=0, bits=0):
    """Draw the requested overlays in place on display-orientation planes.

    planes: [Y, Cb, Cr] uint8 (modified in place); state: dict with
    bitstream-orientation per-fragment arrays "coded", "mode", "mv"
    ([dx, dy]), "qii", and optional "frag_bits". Every overlay is placed
    by the luma fragments.
    """
    pl = geom.planes[0]
    sl = slice(pl.froffset, pl.froffset + pl.nfrags)
    coded = state["coded"][sl]
    fy = geom.frag_y[sl] * 8
    fx = geom.frag_x[sl] * 8
    Y = planes[0]
    # Chroma subsampling of the co-located chroma pixels.
    sx = Y.shape[1] // planes[1].shape[1]
    sy = Y.shape[0] // planes[1].shape[0]

    def disp_y(f):
        # Bitstream row -> display row of luma fragment f's 8px block top.
        return Y.shape[0] - 8 - int(fy[f])

    if mbmode:
        mode = state["mode"][sl]
        for f in np.where(coded)[0]:
            # Luma: darken the top+left border of every coded block.
            y0, x0 = disp_y(f), int(fx[f])
            Y[y0 + 7, x0 : x0 + 8] //= 2
            Y[y0 : y0 + 8, x0] //= 2
        for f in np.where(coded)[0]:
            # Chroma tint per mode on the co-located chroma pixels.
            tint = _MODE_TINT.get(int(mode[f]))
            if tint is None:
                continue
            y0, x0 = disp_y(f) // sy, int(fx[f]) // sx
            for pli, val in ((1, tint[0]), (2, tint[1])):
                blk = planes[pli][y0 : y0 + 8 // sy, x0 : x0 + 8 // sx]
                blk[:] = ((blk.astype(np.int32) + 3 * val) // 4).astype(
                    np.uint8
                )

    if qi and state.get("qii") is not None:
        qii = state["qii"][sl]
        for f in np.where(coded & (qii > 0))[0]:
            y0, x0 = disp_y(f) // sy, int(fx[f]) // sx
            pli = 1 if int(qii[f]) == 1 else 2
            blk = planes[pli][y0 : y0 + 8 // sy, x0 : x0 + 8 // sx]
            blk[:] = np.clip(blk.astype(np.int32) + 48, 0, 255).astype(
                np.uint8
            )

    if mv:
        mvs = state["mv"][sl]
        for f in np.where(coded & ((mvs[:, 0] != 0) | (mvs[:, 1] != 0)))[0]:
            # Center in display coords; mv dy is bitstream-up == display-down
            # negated (frames are stored bottom-up, SURVEY 2.3).
            cy = disp_y(f) + 4
            cx = int(fx[f]) + 4
            dx = int(mvs[f, 0])
            dy = -int(mvs[f, 1])
            n = max(abs(dx), abs(dy), 1)
            ts = np.arange(n + 1) / n
            ys = np.clip((cy + ts * dy / 2).astype(int), 0, Y.shape[0] - 1)
            xs = np.clip((cx + ts * dx / 2).astype(int), 0, Y.shape[1] - 1)
            Y[ys, xs] = 255
            Y[cy, cx] = 0

    if bits and state.get("frag_bits") is not None:
        dense = np.zeros(geom.nfrags, dtype=np.int32)
        dense[state["order"]] = state["frag_bits"]
        for f in np.where(coded)[0]:
            used = int(dense[sl.start + f])
            w = min(8, (used * 8 + 127) // 128)
            if w <= 0:
                continue
            y0 = disp_y(f) + 7
            x0 = int(fx[f])
            Y[y0, x0 : x0 + w] = 255
    return planes
