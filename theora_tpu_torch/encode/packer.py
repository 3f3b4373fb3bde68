"""Host frame packer of the device GOP encoder: headers and the bit-serial
stages of a frame whose coding plan was made on the device.

Port of the part of theora_tpu/encode/encoder.py that
`Encoder.pack_frame_plan` reaches: the constructor's tables,
`flush_headers`, `_frame_header_pack` (up to three qis),
`_dc_predict_and_order` (the branch without trellis plans),
`_coded_flags_pack`, `_mb_modes_pack`, `_mvs_pack`, `_block_qis_pack`
with `sb_run_pack`, and `_pack_tokens` on the native packer
(encode.c:405-421, 487-863, tokenize.c:977-1074). Packing cannot change the
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

# Super-block run codes (encode.c:383-388).
_SB_RUN_VAL_MIN = [1, 2, 4, 6, 10, 18, 34, 4130]
_SB_RUN_CODE_PREFIX = [0, 4, 0xC, 0x38, 0xF0, 0x3E0, 0x3F000]
_SB_RUN_CODE_NBITS = [1, 3, 4, 6, 8, 10, 18]


def sb_run_pack(bw: BitWriter, run: int, flag: int, done: bool) -> None:
    """One run of a long-run flag code (encode.c:405-421)."""
    if run >= 4129:
        while run >= 4129:
            bw.write(0x3FFFF, 18)
            run -= 4129
            if run > 0:
                bw.write(flag, 1)
            elif not done:
                bw.write(0 if flag else 1, 1)
        if run <= 0:
            return
    i = 0
    while run >= _SB_RUN_VAL_MIN[i + 1]:
        i += 1
    bw.write(_SB_RUN_CODE_PREFIX[i] + run - _SB_RUN_VAL_MIN[i],
             _SB_RUN_CODE_NBITS[i])


# Block run codes (encode.c:433-441).
_BLOCK_RUN_CODE_NBITS = [2, 2, 3, 3, 4, 4, 6, 6, 6, 6, 7, 7, 7, 7] + [9] * 16
_BLOCK_RUN_CODE_PATTERN = [
    0x000, 0x001, 0x004, 0x005, 0x00C, 0x00D, 0x038,
    0x039, 0x03A, 0x03B, 0x078, 0x079, 0x07A, 0x07B, 0x1F0,
    0x1F1, 0x1F2, 0x1F3, 0x1F4, 0x1F5, 0x1F6, 0x1F7, 0x1F8,
    0x1F9, 0x1FA, 0x1FB, 0x1FC, 0x1FD, 0x1FE, 0x1FF,
]


def block_run_pack(bw: BitWriter, run: int) -> None:
    """One run (1-30) of the short-run flag code of the blocks' coded
    flags (encode.c:433-441). The packers code those flags natively
    (coded_flags_pack_native); this is the public Python form."""
    bw.write(_BLOCK_RUN_CODE_PATTERN[run - 1], _BLOCK_RUN_CODE_NBITS[run - 1])


def _flag_runs_pack(bw: BitWriter, flags) -> None:
    """The first flag, then the runs of equal flags (encode.c:685-725)."""
    flag = int(flags[0])
    bw.write(flag, 1)
    i, n = 0, len(flags)
    while i < n:
        run = 0
        while i < n and flags[i] == flag:
            run += 1
            i += 1
        sb_run_pack(bw, run, flag, i >= n)
        flag = 1 - flag


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
    def _frame_header_pack(bw: BitWriter, ftype: int, qis) -> None:
        bw.write(0, 1)
        bw.write(ftype, 1)
        bw.write(qis[0], 6)
        for q in qis[1:]:       # each further qi behind a 1 bit
            bw.write(1, 1)
            bw.write(q, 6)
        if len(qis) < 3:
            bw.write(0, 1)
        if ftype == INTRA_FRAME:
            bw.write(0, 3)

    def _block_qis_pack(self, bw: BitWriter, qis, frag_qii, coded) -> None:
        """The coded blocks' qi indices in coded order, as runs of
        "qii > 0", then, with three qis, runs of "qii == 2" over the
        blocks with qii > 0 (encode.c:685-725)."""
        g = self.geometry
        order = np.concatenate([
            fr[coded[fr]] for fr in
            (g.scan_fragis[g.scan_pli == pli] for pli in range(3))])
        if len(order) == 0:
            return
        qii = frag_qii[order]
        _flag_runs_pack(bw, (qii > 0).astype(int))
        if len(qis) < 3 or int((qii == 0).sum()) >= len(qii):
            return
        _flag_runs_pack(bw, qii[qii > 0] - 1)

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
                        qdct_by_frag, frag_mv4=None, qis=None,
                        frag_qii=None) -> bytes:
        """Pack one frame from its device-made plan.

        ftype: INTRA_FRAME or INTER_FRAME; qi: the frame's quantizer;
        coded: [nfrags] bool; frag_refi: [nfrags] FRAME_* (FRAME_NONE for
        uncoded); qdct_by_frag: [nfrags, 64] zig-zag quantized values with
        the actual DC at 0 (prediction happens here); mb_modes [nmbs],
        mb_mvs [nmbs, 2] and frag_mv4 [nfrags, 2] for inter frames; qis:
        adaptive quantization's list of 2-3 qis (qi first) and frag_qii
        [nfrags] each block's index into it, or None for one qi.
        """
        g = self.geometry
        qis = list(qis) if qis is not None and len(qis) > 1 else None
        vecs_by_plane = self._dc_predict_and_order(coded, frag_refi,
                                                   qdct_by_frag)
        bw = BitWriter()
        self._frame_header_pack(bw, ftype, qis or [qi])
        if ftype == INTRA_FRAME:
            if qis is not None:
                self._block_qis_pack(bw, qis, frag_qii, coded)
            return self._pack_tokens(bw, vecs_by_plane)
        self._coded_flags_pack(bw, coded)
        lum = g.mb_maps[:, 0, :]
        has = (lum >= 0) & coded[np.clip(lum, 0, None)]
        coded_mbis = list(np.where(has.any(axis=1) & g.mb_valid)[0])
        self._mb_modes_pack(bw, mb_modes, coded_mbis)
        self._mvs_pack(bw, mb_modes, mb_mvs, coded_mbis, coded, frag_mv4)
        if qis is not None:
            self._block_qis_pack(bw, qis, frag_qii, coded)
        return self._pack_tokens(bw, vecs_by_plane)
