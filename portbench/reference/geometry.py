# Frozen copy of theora_tpu_torch/geometry.py at commit 6cd77e7, imports made relative;
# part of the benchmark's reference decoder, which imports nothing of the port.
"""Frame geometry: fragment planes, super-block Hilbert maps, macro-block
maps, fragment coordinates and the canonical bitstream scan order.

Copy of theora_tpu/geometry.py (state.c:123-332). Fragment row
0 is the *bitstream* bottom row; planes are stored with row 0 = bitstream
row 0 and flipped at the output boundary (internal.c:177-188).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np

from .constants import MB_MAP, SB_HILBERT, UMV_PADDING


@dataclasses.dataclass(frozen=True)
class PlaneGeometry:
    nhfrags: int
    nvfrags: int
    froffset: int
    nfrags: int
    nhsbs: int
    nvsbs: int
    sboffset: int
    nsbs: int


class FrameGeometry:
    """Index maps for one (frame size, pixel format).

    planes: per-plane PlaneGeometry; nfrags, nsbs, nmbs: totals.
    mb_maps: [nmbs, 3, 4] fragment per (mb, plane, block), -1 where absent.
    mb_valid: [nmbs] bool. scan_fragis / scan_sbi / scan_quadi / scan_pli:
    every valid fragment in the canonical super-block scan order
    (decode.c:483-671) with its super block, quadrant and plane.
    frag_x / frag_y: [nfrags] fragment column and row inside its plane.
    """

    def __init__(self, frame_width: int, frame_height: int, pixel_fmt: int):
        self.frame_width = frame_width
        self.frame_height = frame_height
        self.pixel_fmt = pixel_fmt
        hdec = 0 if (pixel_fmt & 1) else 1
        vdec = 0 if (pixel_fmt & 2) else 1
        self.hdec, self.vdec = hdec, vdec

        yh = frame_width >> 3
        yv = frame_height >> 3
        ch = (yh + hdec) >> hdec
        cv = (yv + vdec) >> vdec
        yfrags = yh * yv
        cfrags = ch * cv
        yhsbs, yvsbs = (yh + 3) >> 2, (yv + 3) >> 2
        chsbs, cvsbs = (ch + 3) >> 2, (cv + 3) >> 2
        ysbs, csbs = yhsbs * yvsbs, chsbs * cvsbs

        self.planes = [
            PlaneGeometry(yh, yv, 0, yfrags, yhsbs, yvsbs, 0, ysbs),
            PlaneGeometry(ch, cv, yfrags, cfrags, chsbs, cvsbs, ysbs, csbs),
            PlaneGeometry(
                ch, cv, yfrags + cfrags, cfrags, chsbs, cvsbs, ysbs + csbs,
                csbs,
            ),
        ]
        self.nfrags = yfrags + 2 * cfrags
        self.nsbs = ysbs + 2 * csbs
        self.nmbs = ysbs << 2

        self._build_sb_maps()
        self._build_mb_maps()
        self._build_scan_order()
        local = np.concatenate([np.arange(pl.nfrags) for pl in self.planes])
        nh = np.concatenate([np.full(pl.nfrags, pl.nhfrags)
                             for pl in self.planes])
        self.frag_x = (local % nh).astype(np.int32)
        self.frag_y = (local // nh).astype(np.int32)

    def _build_sb_maps(self) -> None:
        sb_maps = np.full((self.nsbs, 4, 4), -1, dtype=np.int32)
        quad_valid = np.zeros((self.nsbs, 4), dtype=bool)
        for pl in self.planes:
            for sby in range(pl.nvsbs):
                for sbx in range(pl.nhsbs):
                    sbi = pl.sboffset + sby * pl.nhsbs + sbx
                    y0, x0 = sby * 4, sbx * 4
                    for i in range(min(4, pl.nvfrags - y0)):
                        for j in range(min(4, pl.nhfrags - x0)):
                            quad, block = SB_HILBERT[i][j]
                            sb_maps[sbi, quad, block] = (
                                pl.froffset + (y0 + i) * pl.nhfrags + x0 + j
                            )
        # A quad is valid when its top-left block is (state.c:107-112).
        for sbi in range(self.nsbs):
            for quad in range(4):
                quad_valid[sbi, quad] = (
                    sb_maps[sbi, quad, quad & (quad << 1)] >= 0
                )
        self.sb_maps = sb_maps
        self.sb_quad_valid = quad_valid

    def _build_mb_maps(self) -> None:
        mb_maps = np.full((self.nmbs, 3, 4), -1, dtype=np.int32)
        mb_valid = np.ones(self.nmbs, dtype=bool)
        pl0, pl1, pl2 = self.planes
        hdec, vdec = self.hdec, self.vdec
        for sby in range(pl0.nvsbs):
            for sbx in range(pl0.nhsbs):
                sbi = sby * pl0.nhsbs + sbx
                for ymb in range(2):
                    for xmb in range(2):
                        mbi = sbi << 2 | MB_MAP[ymb][xmb]
                        mbx = sbx * 4 + xmb * 2
                        mby = sby * 4 + ymb * 2
                        if mbx >= pl0.nhfrags or mby >= pl0.nvfrags:
                            mb_valid[mbi] = False
                            continue
                        # Luma: 2x2 blocks, flat index i<<1|j
                        # (state.c:189-196).
                        for i in range(2):
                            for j in range(2):
                                fy, fx = mby + i, mbx + j
                                if fy < pl0.nvfrags and fx < pl0.nhfrags:
                                    mb_maps[mbi, 0, i << 1 | j] = (
                                        fy * pl0.nhfrags + fx
                                    )
                        # Chroma (state.c:205-269).
                        cx, cy = mbx >> hdec, mby >> vdec
                        if hdec and vdec:
                            f = cy * pl1.nhfrags + cx
                            mb_maps[mbi, 1, 0] = f + pl1.froffset
                            mb_maps[mbi, 2, 0] = f + pl2.froffset
                        elif hdec:
                            for i in range(2):
                                f = (mby + i) * pl1.nhfrags + cx
                                mb_maps[mbi, 1, i << 1] = f + pl1.froffset
                                mb_maps[mbi, 2, i << 1] = f + pl2.froffset
                        elif vdec:
                            for j in range(2):
                                f = cy * pl1.nhfrags + mbx + j
                                mb_maps[mbi, 1, j] = f + pl1.froffset
                                mb_maps[mbi, 2, j] = f + pl2.froffset
                        else:
                            for k in range(4):
                                f0 = mb_maps[mbi, 0, k]
                                mb_maps[mbi, 1, k] = f0 + pl1.froffset
                                mb_maps[mbi, 2, k] = f0 + pl2.froffset
        self.mb_maps = mb_maps
        self.mb_valid = mb_valid

    def _build_scan_order(self) -> None:
        fragis, sbis, quadis = [], [], []
        for sbi in range(self.nsbs):
            for quad in range(4):
                if not self.sb_quad_valid[sbi, quad]:
                    continue
                for bi in range(4):
                    fragi = self.sb_maps[sbi, quad, bi]
                    if fragi >= 0:
                        fragis.append(fragi)
                        sbis.append(sbi)
                        quadis.append(quad)
        self.scan_fragis = np.array(fragis, dtype=np.int32)
        self.scan_sbi = np.array(sbis, dtype=np.int32)
        self.scan_quadi = np.array(quadis, dtype=np.int32)
        bounds = [self.planes[0].nsbs,
                  self.planes[0].nsbs + self.planes[1].nsbs]
        self.scan_pli = np.digitize(self.scan_sbi, bounds).astype(np.int32)

    def plane_shape(self, pli: int) -> tuple[int, int]:
        """(height, width) in pixels of a plane."""
        if pli == 0:
            return self.frame_height, self.frame_width
        return (
            self.frame_height >> self.vdec,
            self.frame_width >> self.hdec,
        )

    def plane_padding(self, pli: int) -> tuple[int, int]:
        """(vpadding, hpadding) of the UMV border (state.c:778-809)."""
        if pli == 0:
            return UMV_PADDING, UMV_PADDING
        return UMV_PADDING >> self.vdec, UMV_PADDING >> self.hdec


@functools.lru_cache(maxsize=8)
def get_geometry(frame_width: int, frame_height: int,
                 pixel_fmt: int) -> FrameGeometry:
    return FrameGeometry(frame_width, frame_height, pixel_fmt)
