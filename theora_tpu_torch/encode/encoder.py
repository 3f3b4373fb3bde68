"""Host encoder, keyframe path.

Port of the keyframe path of theora_tpu/encode/encoder.py (`Encoder`):
the constructor's fields that path reads, `set_splevel`, `encode_frame`
for keyframes with one-pass rate control (encode/rate.py; keyframes are
never dropped), `_encode_intra`, the three intra branches of
`_transform_quantize` (the multi-qi trellis `_tq_trellis_multi_qi`, the
device-precomputed fDCT + quantization, the native one), the trellis
planner's bit tables, `_select_adaptive_qis` (gates and qi triple from
encode/aq.py), `_dc_predict_and_order`'s branches and the token packing.
Headers, the frame header and the qi-index runs come from
encode/packer.py:FramePacker. The host tier is native (C++, native/),
with no pure-Python fallback.

Left out: the embedded decoder and the closed-loop reconstruction, which
an all-keyframe encode never reads back (its packets do not change; the
tests hold them to the JAX Encoder's byte for byte), and the inter path
(ROADMAP item 9c): `encode_frame` raises NotImplementedError on a frame
that would not be a keyframe. With use_trellis=False at speed levels 0-1
(set directly; set_splevel never makes it), a frame that engages
adaptive quantization's qi triple raises NotImplementedError too.
"""
from __future__ import annotations

import numpy as np

from theora_tpu_torch.bitio import BitWriter
from theora_tpu_torch.constants import DCT_TOKEN_EXTRA_BITS, FRAME_SELF
from theora_tpu_torch.encode import aq
from theora_tpu_torch.encode.packer import FramePacker
from theora_tpu_torch.encode.rate import RateControl
from theora_tpu_torch.info import INTRA_FRAME, TheoraInfo
from theora_tpu_torch.native import (
    dc_residuals_native,
    fdct_quantize_rd_native,
    trellis_plan_blocks_native,
)
from theora_tpu_torch.ops.transforms import rd_lambda
from theora_tpu_torch.tables import RD_LAMBDA
from theora_tpu_torch.tpkt import Packet

# qii signalling cost in bits of the per-block chooser: ~1 for the base
# row, ~2 for the others (encoder.py:838).
_QII_SIG = np.array([1.0, 2.0, 2.0])


def _quantize(dct: np.ndarray, dq: np.ndarray) -> np.ndarray:
    """Round-to-nearest quantizer, ties away from zero
    (enquant.c:220-249); int64."""
    d = dq.astype(np.int64)
    v2 = np.abs(dct.astype(np.int64)) << 1
    q = np.where(v2 >= d, (v2 + d) // (2 * d), 0)
    return np.sign(dct) * q


class Encoder:
    """Theora encoder of keyframes (the host tier)."""

    def __init__(self, info: TheoraInfo, qinfo: dict | None = None,
                 huff_codes: list | None = None):
        self._fp = FramePacker(info, qinfo, huff_codes)
        self.info = info
        self.huff_codes = self._fp.huff_codes
        self.geometry = self._fp.geometry
        self.dequant = self._fp.dequant
        self.qi = max(0, min(63, info.quality))
        self.rd_quant = True
        self.rd_strength = 3.0
        self.use_trellis = True
        self.sp_level = 0
        # AC Huffman indices of the last packed frame of each type, the
        # trellis' cost model (encode.c:838-858 carry).
        self._huff_pred = [[0, 0], [0, 0]]
        self._nb_cache = {}
        self.adaptive_quant = "auto"
        self.aq_lambda_scale = 1.0
        self._frame_qis = None
        self._frag_qii_rd = None
        self._frag_lam_scale = None
        self._aq_scale_frame = self.aq_lambda_scale
        # None, or a callable (planes, qi) -> {pli: (dct16, qdct)}: a
        # single-qi keyframe's zig-zag fDCT and round-to-nearest
        # quantization ([n, 64] int16 each, blocks in raster order),
        # computed elsewhere (BatchIntraEncoder's K2 launches). The
        # counterpart of the JAX Encoder's _precomputed_tq; called only
        # where the device branch takes the results (one qi, speed 0-1).
        self.device_tq = None
        self.rc = None
        self.curframe_num = -1
        self.keyframe_num = 0
        self.packetno = 0
        self.keyframe_freq = 64
        self._frames_since_keyframe = -1
        self.granpos = -1

    def flush_headers(self) -> list[Packet]:
        self.packetno = 3
        return self._fp.flush_headers()

    def set_splevel(self, lvl: int) -> None:
        """Speed level (encoder.py:324-340): 0-1 the trellis, 2 the
        heuristic R/D quantizer, 3 the plain quantizer; 2 and more turn
        adaptive quantization off. 4 only changes inter frames."""
        if not 0 <= lvl <= 4:
            raise ValueError("speed level out of range")
        self.sp_level = lvl
        self.use_trellis = lvl < 2
        self.rd_quant = lvl < 3

    @property
    def frame_qis(self):
        return self._frame_qis or [self.qi]

    # ------------------------------------------------------------------
    def frame_gates(self, ycbcr):
        """The adaptive-quantization gates of a frame (display
        orientation), or None where no qi triple can engage (mode off,
        speed 2 and more): (noise_like, mixed, luma lambda scales)."""
        if not self.adaptive_quant or self.sp_level >= 2:
            return None
        return aq.frame_gates(np.ascontiguousarray(ycbcr[0][::-1]),
                              self.adaptive_quant, keep_noise_scales=True)

    def keyframe_qis(self, gates) -> list:
        """The qi list a keyframe with these gates takes at the current
        qi (encoder.py:964-1049 at qti 0)."""
        if gates is None:
            return [self.qi]
        nl, mixed, sc = gates
        qis = aq.qi_triple(self.adaptive_quant, self.qi, 0,
                           int(self.info.pixel_fmt), nl, mixed,
                           sc is not None)
        return qis or [self.qi]

    def uses_device_tq(self, qis) -> bool:
        """Whether a keyframe with this qi list takes precomputed fDCT +
        quantization results: one qi and the trellis (encoder.py:553-566;
        a multi-qi frame runs the host's multi-qi trellis, speed levels 2
        and more the host's quantizers)."""
        return len(qis) == 1 and self.use_trellis

    # ------------------------------------------------------------------
    def encode_frame(self, ycbcr: list, e_o_s: bool = False,
                     gates=None) -> Packet:
        """Encode one keyframe (display-orientation planes) -> Packet.

        gates: the frame's `frame_gates(ycbcr)`, when the caller has
        them already."""
        fsk = self._frames_since_keyframe + 1
        if self.curframe_num >= 0 and fsk < self.keyframe_freq:
            raise NotImplementedError(
                "inter frames are not ported: the host encoder's inter path "
                "is ROADMAP item 9c; use keyframe_freq=1")
        if gates is None:
            gates = self.frame_gates(ycbcr)
        self.curframe_num += 1
        self._frames_since_keyframe = 0
        if self.info.target_bitrate > 0 and self.rc is None:
            self.rc = RateControl(self.info, self.keyframe_freq)
        planes = [p[::-1].astype(np.uint8) for p in ycbcr]
        if self.rc is not None:
            self.qi = self.rc.select_qi(INTRA_FRAME, self.qi)
        # GOP-local trellis cost model (encoder.py:377-379).
        self._huff_pred = [[0, 0], [0, 0]]
        data = self._encode_intra(planes, gates)
        self.keyframe_num = self.curframe_num
        if self.rc is not None:
            self.rc.update(INTRA_FRAME, self.qi, len(data) * 8)
        shift = self.info.keyframe_granule_shift
        self.granpos = ((self.keyframe_num + 1) << shift) + (
            self.curframe_num - self.keyframe_num)
        pkt = Packet(data, granulepos=self.granpos, packetno=self.packetno,
                     e_o_s=e_o_s)
        self.packetno += 1
        return pkt

    # ------------------------------------------------------------------
    def _select_adaptive_qis(self, gates):
        """The frame's qi list and, with the triple, the per-fragment qii
        array the multi-qi trellis fills (encoder.py:1122-1177)."""
        self._frame_qis = None
        self._frag_lam_scale = None
        qis = self.keyframe_qis(gates)
        if len(qis) == 1:
            return None
        if not self.use_trellis:
            raise NotImplementedError(
                "adaptive quantization's qi triple without the trellis "
                "(use_trellis=False at speed levels 0-1) is not ported")
        g = self.geometry
        nl, _, sc = gates
        self._aq_scale_frame = aq.chooser_lambda_scale(
            self.adaptive_quant, self.qi, 0, int(self.info.pixel_fmt), nl,
            self.aq_lambda_scale)
        if sc is not None:
            full = np.ones(g.nfrags, np.float64)
            full[:g.planes[0].nfrags] = sc
            self._frag_lam_scale = full
        self._frame_qis = qis
        self._frag_qii_rd = np.zeros(g.nfrags, dtype=np.int32)
        return self._frag_qii_rd

    def _encode_intra(self, planes, gates) -> bytes:
        g = self.geometry
        frag_qii = self._select_adaptive_qis(gates)
        qis = self.frame_qis
        pre = None
        if self.device_tq is not None and self.uses_device_tq(qis):
            pre = self.device_tq(planes, qis[0])
        per_plane = [self._transform_quantize(planes, pli, pre)
                     for pli in range(3)]
        bw = BitWriter()
        self._fp._frame_header_pack(bw, INTRA_FRAME, qis)
        if frag_qii is not None:
            self._fp._block_qis_pack(bw, qis, frag_qii,
                                     np.ones(g.nfrags, bool))
        return self._pack(bw, self._dc_predict_and_order(per_plane))

    # ------------------------------------------------------------------
    def _transform_quantize(self, planes, pli, pre):
        """fDCT + quantization of every block of plane pli (raster
        order): (qdct [n, 64] int32 zig-zag with the quantized DC, the
        trellis plans [n, 66, 4] int16 or None)."""
        pl = self.geometry.planes[pli]
        n = pl.nfrags
        qis = self.frame_qis
        qti = np.zeros(n, np.int32)
        if pre is not None:
            # Device-computed fDCT + quantization (encoder.py:565-586).
            dct16 = np.ascontiguousarray(pre[pli][0])
            qdct = pre[pli][1].astype(np.int32)
            return qdct, self._trellis_plan_blocks(pli, qdct, dct16, qti)
        h, w = pl.nvfrags * 8, pl.nhfrags * 8
        res = (planes[pli][:h, :w].reshape(pl.nvfrags, 8, pl.nhfrags, 8)
               .transpose(0, 2, 1, 3).reshape(-1, 8, 8).astype(np.int32)
               - 128)
        if len(qis) > 1:
            return self._tq_trellis_multi_qi(pli, res, qti, qis)
        dq = self.dequant[qis[0], pli, 0]
        if self.use_trellis:
            qz, _, _, dct16 = fdct_quantize_rd_native(
                res, dq, 0.0, rd=False, want_dct=True)
            qdct = qz.astype(np.int32)
            return qdct, self._trellis_plan_blocks(pli, qdct, dct16, qti)
        lam = rd_lambda(qis[0], int(dq[1])) * self.rd_strength
        qz, _, _ = fdct_quantize_rd_native(res, dq, lam, rd=self.rd_quant)
        return qz.astype(np.int32), None

    def _tq_trellis_multi_qi(self, pli, res, qti, qis):
        """fDCT once, then quantization and a trellis plan per qi row;
        each block's qii by exact R/D cost, err2 + lambda (acbits +
        signalling). DC always quantizes with qis[0] (decode.c:1530).
        encoder.py:690-853 with its estimate pass off (the default
        aq_estimate_margin None)."""
        g = self.geometry
        pl = g.planes[pli]
        n = len(res)
        fti = 0
        lam = (RD_LAMBDA.get(int(self.info.pixel_fmt), RD_LAMBDA[0])[fti][
            qis[0]] * self._aq_scale_frame)
        scale = self._frag_lam_scale
        sl = slice(pl.froffset, pl.froffset + n)
        lam_b = lam * scale[sl] if scale is not None else lam
        nbt = self._nb_table(pli, fti)
        dq0 = self.dequant[qis[0], pli]
        qdct0, _, _, dct16 = fdct_quantize_rd_native(
            res, dq0[0], 0.0, rd=False, want_dct=True)
        paths0, acbits0, err20 = trellis_plan_blocks_native(
            dct16, qdct0, dq0[0], dq0[1], qti, lam_b, nbt)
        qdcts, pathss, acbitss, err2s = [qdct0], [paths0], [acbits0], [err20]
        big = np.int64(1) << 62
        for qi in qis[1:]:
            # A coarser row only wins by saving bits, a finer one only by
            # cutting error (encoder.py:761-764).
            cand = err20 > lam_b if qi > qis[0] else acbits0 > 1
            idx = np.nonzero(cand)[0]
            qdct = qdct0.copy()
            paths = paths0.copy()
            acb = acbits0.copy()
            err = np.full(n, big, np.int64)
            if len(idx):
                d16c = np.ascontiguousarray(dct16[idx])
                dq = self.dequant[qi, pli]
                qsub = _quantize(d16c, dq[0]).astype(np.int16)
                qsub[:, 0] = _quantize(d16c[:, :1], dq0[0][:1]).reshape(-1)
                p_s, a_s, e_s = trellis_plan_blocks_native(
                    d16c, qsub, dq[0], dq[1], qti[idx],
                    lam_b[idx] if isinstance(lam_b, np.ndarray) else lam,
                    nbt)
                qdct[idx] = qsub
                paths[idx] = p_s
                acb[idx] = a_s
                err[idx] = e_s
            qdcts.append(qdct)
            pathss.append(paths)
            acbitss.append(acb)
            err2s.append(err)
        costs = np.stack([
            err2s[q] + (lam_b * (acbitss[q] + _QII_SIG[q])).astype(np.int64)
            for q in range(len(qis))])
        best = np.argmin(costs, axis=0).astype(np.int32)
        rows = np.arange(n)
        self._frag_qii_rd[sl] = best
        return (np.stack(qdcts)[best, rows].astype(np.int32),
                np.stack(pathss)[best, rows])

    def _nb_table(self, pli, fti):
        """[5, 32] int64 bit cost of each token per zig-zag group, from
        the AC Huffman table the previous frame of this type chose for
        the plane's kind."""
        idx = self._huff_pred[fti][(pli + 1) >> 1]
        nbt = self._nb_cache.get(idx)
        if nbt is None:
            nbt = np.zeros((5, 32), dtype=np.int64)
            for gi in range(5):
                for t in range(32):
                    nbt[gi, t] = (self.huff_codes[(gi << 4) + idx][t][1]
                                  + DCT_TOKEN_EXTRA_BITS[t])
            self._nb_cache[idx] = nbt
        return nbt

    def _trellis_plan_blocks(self, pli, qdct, dct16, qti):
        """Plan every block at the frame's base qi and lambda; rewrites
        the AC values of qdct in place. Returns the plans."""
        fti = 0
        qi0 = self.frame_qis[0]
        lam = RD_LAMBDA.get(int(self.info.pixel_fmt), RD_LAMBDA[0])[fti][qi0]
        qd16 = np.ascontiguousarray(qdct, dtype=np.int16)
        dq = self.dequant[qi0, pli]
        paths, _, _ = trellis_plan_blocks_native(
            dct16, qd16, dq[0], dq[1], qti, lam, self._nb_table(pli, fti))
        qdct[:] = qd16
        return paths

    # ------------------------------------------------------------------
    def _dc_predict_and_order(self, per_plane):
        """DC-predict every plane (raster order) and order the blocks in
        coded (scan) order (encoder.py:1318-1381). With trellis plans:
        per plane (plans, scan -> raster permutation, scan-order DC
        residuals); without: per plane [n, 64] int16 vectors with the DC
        residual at 0."""
        g = self.geometry
        out = []
        for pli, (qdct, paths) in enumerate(per_plane):
            pl = g.planes[pli]
            shape = (pl.nvfrags, pl.nhfrags)
            dc_resid = dc_residuals_native(
                np.ones(shape, bool), np.full(shape, FRAME_SELF, np.int32),
                qdct[:, 0].reshape(shape), [0, 0, 0]).reshape(-1)
            scan = g.scan_fragis[g.scan_pli == pli] - pl.froffset
            if paths is not None:
                out.append((paths, scan.astype(np.int32),
                            dc_resid[scan].astype(np.int32)))
            else:
                vecs = qdct[scan].astype(np.int16)
                vecs[:, 0] = dc_resid[scan]
                out.append(vecs)
        return out

    def _pack(self, bw: BitWriter, ordered) -> bytes:
        """The residual section after the header bits in bw: the trellis
        plans' replay (storing the chosen AC tables for the next frame's
        cost model, encode.c:838-858) or the vectors' tokenization."""
        if isinstance(ordered[0], tuple):
            pkt, chosen = self._fp._packer.pack_frame_trellis_perm(
                *zip(*ordered), bw.bytes(), bw.bitpos)
            self._huff_pred[0] = chosen[2:]
            return pkt
        return self._fp._packer.pack_frame(
            np.concatenate(ordered), [len(v) for v in ordered], bw.bytes(),
            bw.bitpos)
