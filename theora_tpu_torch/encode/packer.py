"""Host frame packer of the device GOP encoder: headers and the bit-serial
stages of a frame whose coding plan was made on the device.

Port of the part of theora_tpu/encode/encoder.py that
`Encoder.pack_frame_plan` reaches for a single-qi frame: the constructor's
tables, `flush_headers`, `_frame_header_pack`, `_dc_predict_and_order`
(the branch without trellis plans), `_coded_flags_pack`,
`_mb_modes_pack`, `_mvs_pack` and `_pack_tokens` on the native packer
(encode.c:487-863, tokenize.c:977-1074). Packing cannot change the
reconstruction, so the device's closed loop stays in step with any
decoder of the packets.
"""
from __future__ import annotations

import numpy as np

from theora_tpu_torch import tables
from theora_tpu_torch.bitio import BitWriter
from theora_tpu_torch.constants import (
    MODE_ALPHABETS,
    MODE_GOLDEN_MV,
    MODE_INTER_MV,
    MODE_INTER_MV_FOUR,
)
from theora_tpu_torch.geometry import get_geometry
from theora_tpu_torch.headers import (
    pack_comment_header,
    pack_info_header,
    pack_setup_header,
)
from theora_tpu_torch.huffman import MV_VLC_BOOK
from theora_tpu_torch.info import INTRA_FRAME, TheoraInfo
from theora_tpu_torch.native import (
    NativeTokenPacker,
    coded_flags_pack_native,
    dc_residuals_native,
    mb_modes_pack_native,
)
from theora_tpu_torch.quant import dequant_tables_init
from theora_tpu_torch.tpkt import Packet


class FramePacker:
    """Packs headers and frames for one stream configuration."""

    def __init__(self, info: TheoraInfo, qinfo: dict | None = None,
                 huff_codes: list | None = None):
        info.validate()
        self.info = info
        self.qinfo = qinfo if qinfo is not None else tables.DEF_QUANT_INFO
        self.huff_codes = (huff_codes if huff_codes is not None
                           else tables.VP31_HUFF_CODES)
        self.geometry = get_geometry(info.frame_width, info.frame_height,
                                     int(info.pixel_fmt))
        # uint16 [64 qi][3 pli][2 qti][64 zzi].
        self.dequant = dequant_tables_init(self.qinfo)
        self._packer = NativeTokenPacker(self.huff_codes)
        # MV component value -> (pattern, nbits) of the VLC.
        self._mv_vlc = {}
        for t, p, n in MV_VLC_BOOK.codes:
            self._mv_vlc.setdefault(t - 32, (p, n))

    def flush_headers(self) -> list[Packet]:
        return [
            Packet(pack_info_header(self.info), b_o_s=True, granulepos=0,
                   packetno=0),
            Packet(pack_comment_header(), granulepos=0, packetno=1),
            Packet(pack_setup_header(self.qinfo, self.huff_codes),
                   granulepos=0, packetno=2),
        ]

    @staticmethod
    def _frame_header_pack(bw: BitWriter, ftype: int, qi: int) -> None:
        bw.write(0, 1)
        bw.write(ftype, 1)
        bw.write(qi, 6)
        bw.write(0, 1)          # one qi: no second one follows
        if ftype == INTRA_FRAME:
            bw.write(0, 3)

    def _dc_predict_and_order(self, coded, frag_refi, qdct_by_frag):
        """DC-predict every plane (raster order) and order the coded
        blocks' coefficient vectors in coded (scan) order; returns
        per-plane [n, 64] int16 vectors with the DC residual at 0."""
        g = self.geometry
        out = []
        for pli in range(3):
            pl = g.planes[pli]
            sl = slice(pl.froffset, pl.froffset + pl.nfrags)
            shape = (pl.nvfrags, pl.nhfrags)
            q = qdct_by_frag[sl].astype(np.int16)
            dc_resid = dc_residuals_native(
                coded[sl].reshape(shape), frag_refi[sl].reshape(shape),
                np.where(coded[sl], q[:, 0], 0).astype(np.int32)
                .reshape(shape),
                [0, 0, 0],
            ).reshape(-1)
            scan = g.scan_fragis[g.scan_pli == pli]
            scan = scan[coded[scan]] - pl.froffset
            vecs = np.where(coded[sl][:, None], q, 0)[scan]
            vecs[:, 0] = dc_resid[scan]
            out.append(vecs)
        return out

    def _coded_flags_pack(self, bw: BitWriter, coded) -> None:
        """(encode.c:487-589)"""
        g = self.geometry
        buf, nbits, _ = coded_flags_pack_native(coded, g.scan_fragis,
                                                g.scan_sbi, g.nsbs)
        bw.append_bits(buf, nbits)

    @staticmethod
    def _mb_modes_pack(bw: BitWriter, mb_modes, coded_mbis) -> None:
        """Scheme selection by exact bit count, then emission
        (encode.c:591-621)."""
        buf, nbits = mb_modes_pack_native(
            [int(mb_modes[mbi]) for mbi in coded_mbis], MODE_ALPHABETS)
        bw.append_bits(buf, nbits)

    def _mvs_pack(self, bw: BitWriter, mb_modes, mb_mvs, coded_mbis, coded,
                  frag_mv4) -> None:
        """(encode.c:623-683); frag_mv4: [nfrags, 2] per-block vectors of
        the 4MV macroblocks."""
        g = self.geometry
        mvs = []
        for mbi in coded_mbis:
            mode = int(mb_modes[mbi])
            if mode in (MODE_INTER_MV, MODE_GOLDEN_MV):
                mvs.append((int(mb_mvs[mbi, 0]), int(mb_mvs[mbi, 1])))
            elif mode == MODE_INTER_MV_FOUR:
                for bi in range(4):
                    fragi = g.mb_maps[mbi, 0, bi]
                    if fragi >= 0 and coded[fragi]:
                        mvs.append((int(frag_mv4[fragi, 0]),
                                    int(frag_mv4[fragi, 1])))
        vlc_total = sum(self._mv_vlc[dx][1] + self._mv_vlc[dy][1]
                        for dx, dy in mvs)
        scheme = 1 if 12 * len(mvs) < vlc_total else 0
        bw.write(scheme, 1)
        for dx, dy in mvs:
            for v in (dx, dy):
                if scheme == 0:
                    bw.write(*self._mv_vlc[v])
                else:
                    bw.write(2 * abs(v) + (1 if v < 0 else 0), 6)

    def _pack_tokens(self, bw: BitWriter, vecs_by_plane) -> bytes:
        vecs = np.concatenate(vecs_by_plane)
        return self._packer.pack_frame(vecs, [len(v) for v in vecs_by_plane],
                                       bw.bytes(), bw.bitpos)

    def pack_frame_plan(self, ftype, qi, coded, frag_refi, mb_modes, mb_mvs,
                        qdct_by_frag, frag_mv4=None) -> bytes:
        """Pack one frame from its device-made plan.

        ftype: INTRA_FRAME or INTER_FRAME; qi: the frame's quantizer;
        coded: [nfrags] bool; frag_refi: [nfrags] FRAME_* (FRAME_NONE for
        uncoded); qdct_by_frag: [nfrags, 64] zig-zag quantized values with
        the actual DC at 0 (prediction happens here); mb_modes [nmbs],
        mb_mvs [nmbs, 2] and frag_mv4 [nfrags, 2] for inter frames.
        """
        g = self.geometry
        vecs_by_plane = self._dc_predict_and_order(coded, frag_refi,
                                                   qdct_by_frag)
        bw = BitWriter()
        self._frame_header_pack(bw, ftype, qi)
        if ftype == INTRA_FRAME:
            return self._pack_tokens(bw, vecs_by_plane)
        self._coded_flags_pack(bw, coded)
        lum = g.mb_maps[:, 0, :]
        has = (lum >= 0) & coded[np.clip(lum, 0, None)]
        coded_mbis = list(np.where(has.any(axis=1) & g.mb_valid)[0])
        self._mb_modes_pack(bw, mb_modes, coded_mbis)
        self._mvs_pack(bw, mb_modes, mb_mvs, coded_mbis, coded, frag_mv4)
        return self._pack_tokens(bw, vecs_by_plane)
