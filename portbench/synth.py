"""Seeded synthetic clips: the content every cell encodes.

The pattern of bench.py:26 `gen_frames` at commit 6cd77e7, rewritten to
take a seed and to give any frame on its own: a detailed static scene
(texture and gradients), three textured movers with coloured chroma, and a
film-grain panel of fresh noise in every frame, over mostly static chroma.
At 1280x720 the sizes, speeds and places are bench.py's; at other sizes
they scale with the frame. The seed sets the texture, the movers' content
and the grain, never a size or a speed, so every seed gives the encoder
the same kind and amount of work.
"""
from __future__ import annotations

import numpy as np

# (height, width, dx, dy, x0, y0) of the movers at 1280x720 (bench.py).
_MOVERS = ((96, 128, 9, 2, 60, 40), (64, 64, -5, 4, 400, 900),
           (80, 112, 3, -3, 520, 300))
_GRAIN = 256  # the grain panel's side at 1280x720


class Clip:
    """Frames of one session's clip: frame(t) is [y, u, v] uint8 planes,
    display orientation, 4:2:0."""

    def __init__(self, width: int, height: int, seed: int):
        self.w, self.h = w, h = width, height
        self.seed = int(seed)
        rng = np.random.default_rng([self.seed, 0])
        sy, sx = h / 720.0, w / 1280.0
        yy, xx = np.mgrid[0:h, 0:w]
        tex = rng.integers(-40, 41, size=(h, w)).astype(np.float64)
        self.bg = (128 + 50 * np.sin(xx / 7.0) * np.cos(yy / 9.0)
                   + 30 * np.sin((xx + 2 * yy) / 61.0)
                   + tex * 0.5).clip(0, 255).astype(np.uint8)
        self.ug = (128 + 40 * np.sin(xx[::2, ::2] / 37.0)).astype(np.uint8)
        self.vg = (128 + 40 * np.cos(yy[::2, ::2] / 29.0)).astype(np.uint8)
        self.movers = []
        for mi, (ph, pw, dx, dy, x0, y0) in enumerate(_MOVERS):
            ph = max(8, int(round(ph * sy)) & ~1)
            pw = max(8, int(round(pw * sx)) & ~1)
            if mi == 2:
                patch = ((128 + 90 * np.sin(np.arange(ph)[:, None] / 3.0))
                         .astype(np.uint8) * np.ones((1, pw), np.uint8))
            else:
                patch = rng.integers(0, 256, size=(ph, pw)).astype(np.uint8)
            self.movers.append((patch, dx, dy, int(x0 * sx), int(y0 * sy)))
        self.grain = (max(8, int(round(_GRAIN * sy))),
                      max(8, int(round(_GRAIN * sx))))

    def frame(self, t: int) -> list[np.ndarray]:
        h, w = self.h, self.w
        y, u, v = self.bg.copy(), self.ug.copy(), self.vg.copy()
        for mi, (patch, dx, dy, x0, y0) in enumerate(self.movers):
            ph, pw = patch.shape
            py = ((y0 + dy * t) % (h - ph)) & ~1
            px = ((x0 + dx * t) % (w - pw)) & ~1
            y[py:py + ph, px:px + pw] = patch
            u[py // 2:(py + ph) // 2, px // 2:(px + pw) // 2] = 80 + 50 * mi
            v[py // 2:(py + ph) // 2, px // 2:(px + pw) // 2] = 190 - 40 * mi
        gh, gw = self.grain
        grain = np.random.default_rng([self.seed, 1, t])
        y[h - gh:, w - gw:] = grain.integers(0, 256, size=(gh, gw),
                                             dtype=np.uint8)
        return [y, u, v]

    def frames(self, n: int) -> list[list[np.ndarray]]:
        return [self.frame(t) for t in range(n)]
