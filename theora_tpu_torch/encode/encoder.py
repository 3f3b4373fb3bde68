"""Host encoder: keyframes and inter frames, with its closed loop decoded
on the card.

Port of theora_tpu/encode/encoder.py (`Encoder`): the constructor's fields
these paths read, `set_splevel`, `encode_frame` (the keyframe decision,
the auto-keyframe retry, the original-frame references of the motion
search; rate control: one-pass CBR, where an inter frame that busts the
budget is dropped, and pass 2 of a 2-pass encode at pass 1's keyframes),
`_drop_frame_pack` (VP3 compatibility's explicit drop frame),
`_encode_intra`; `_encode_inter` (luma motion estimation on the original
references, the no-MV and golden SADs, the integer intra cost, the 4MV
block refinement, the native mode decision with its fragment fill; speed
2 skips 4MV, speed 4 motion compensation), `_encode_inter_tail` (the
residuals against the reconstructed references, adaptive quantization's
qis, the early skip of speed 1 and more, the R/D skip), `_finish_inter`;
`_transform_quantize` with its branches (the multi-qi trellis
`_tq_trellis_multi_qi`, the device-precomputed fDCT + quantization of a
keyframe, the native one with the trellis or the R/D quantizer), the
trellis planner's bit tables, `_select_adaptive_qis` (gates and qi triple
from encode/aq.py), `_dc_predict_and_order`, `_uncoded_ssd_plane`,
`_pad_plane` and the token packing. Headers, the frame header, the coded
flags, the modes, the vectors and the qi-index runs come from
encode/packer.py:FramePacker. The host tier is native (C++, native/),
with no pure-Python fallback.

The closed loop. The JAX Encoder rebuilds its references with an
embedded host Decoder (or its entropy-free twin, which gives the same
planes: encoder.py:181-187). Here the references come from a
PacketDecoder on the encoder's device, built from the encoder's own setup
at the first inter frame that needs them: it decodes the final packets
since its last decode (0-byte ones included), through kernel K1's decode
entry, motion compensation, the loop filter and the borders, and hands
the padded planes to the host once per inter frame. A keyframe's packet
replaces every older undecoded packet, so an all-keyframe encode builds no
decoder. Because only final packets are decoded, the auto-keyframe retry
needs none of the JAX decoder's rewinds (encoder.py:383-404).

A dropped frame is a 0-byte packet (or, with vp3_compatible, an inter
frame that codes no block); the closed loop decodes it like any final
packet, so its references stay put, as the JAX Encoder's do.
vp3_compatible also turns adaptive quantization off and makes an inter
frame that codes no block a drop frame.

Left out (ROADMAP section 1): collect, mode_rd, coupled_skip, the luma
skip guards and luma_ext_skip (off by default), fast_recon and the
pack/recon overlap thread. With
use_trellis=False at speed levels 0-1 (set directly; set_splevel never
makes it), a frame that engages adaptive quantization's qi triple raises
NotImplementedError.

Fault F6 of the reference, not copied: where a plane of a multi-qi frame
has no block left to code before the transform (the early skip of speed
1), the JAX Encoder keeps no trellis plans for it, so a later plane's
plans and its columns cannot be packed together (ROADMAP section 3); the
port gives the plane empty plans, as on a one-qi frame.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from theora_tpu_torch import resolve_device
from theora_tpu_torch.bitio import BitWriter
from theora_tpu_torch.constants import (
    DCT_TOKEN_EXTRA_BITS,
    FRAME_GOLD,
    FRAME_NONE,
    FRAME_SELF,
    MODE_INTER_NOMV,
    MVMAP,
    MVMAP2,
)
from theora_tpu_torch.decode.scalar import PacketDecoder
from theora_tpu_torch.encode import aq
from theora_tpu_torch.encode.packer import FramePacker, sb_run_pack
from theora_tpu_torch.encode.rate import RateControl
from theora_tpu_torch.headers import SetupInfo
from theora_tpu_torch.huffman import Codebook
from theora_tpu_torch.info import INTER_FRAME, INTRA_FRAME, TheoraInfo
from theora_tpu_torch.native import (
    dc_residuals_native,
    enc_residuals_native,
    fdct_quantize_rd_native,
    me_block_refine_native,
    mode_decide_fill_native,
    motion_estimate_native,
    sad_batch_native,
    ssd8_plane_native,
    trellis_plan_blocks_native,
)
from theora_tpu_torch.ops.transforms import rd_lambda
from theora_tpu_torch.tables import RD_LAMBDA
from theora_tpu_torch.tpkt import Packet

# qii signalling cost in bits of the per-block chooser: ~1 for the base
# row, ~2 for the others (encoder.py:838).
_QII_SIG = np.array([1.0, 2.0, 2.0])
# A mode's SAD where its search is skipped (speed levels 2 and 4).
_NO_SAD = np.int64(1) << 40
# Skip-decision lambda multiplier on top of rd_strength * 4.
_SKIP_LAMBDA_SCALE = 2.5


def _quantize(dct: np.ndarray, dq: np.ndarray) -> np.ndarray:
    """Round-to-nearest quantizer, ties away from zero
    (enquant.c:220-249); int64."""
    d = dq.astype(np.int64)
    v2 = np.abs(dct.astype(np.int64)) << 1
    q = np.where(v2 >= d, (v2 + d) // (2 * d), 0)
    return np.sign(dct) * q


def _pad_plane(plane: np.ndarray, pad: int = 16) -> np.ndarray:
    return np.pad(plane, pad, mode="edge")


class Encoder:
    """Theora encoder (the host tier), its closed loop decoded on `device`
    ("cuda" unless the caller asks for "cpu")."""

    def __init__(self, info: TheoraInfo, qinfo: dict | None = None,
                 huff_codes: list | None = None,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self._fp = FramePacker(info, qinfo, huff_codes)
        self.info = info
        self.huff_codes = self._fp.huff_codes
        self.qinfo = self._fp.qinfo
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
        self._cur_fti = 0
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
        # VP3 compatibility: explicit drop-frame packets in place of
        # 0-byte dups (encode.c:865-906), no adaptive quantization; pair
        # with the VP31 quantization and Huffman tables.
        self.vp3_compatible = False
        self.rc = None
        self.curframe_num = -1
        self.keyframe_num = 0
        self.packetno = 0
        self.keyframe_freq = 64
        self._frames_since_keyframe = -1
        self.granpos = -1
        # The original frames the motion search reads (the *_ORIG
        # references, mcenc.c:314-316).
        self._prev_orig = None
        self._gold_orig = None
        self._last_kf_size = 0
        self._frag_mv4 = np.zeros((self.geometry.nfrags, 2), dtype=np.int32)
        # The closed loop: the decoder (built at the first inter frame)
        # and the final packets it has not decoded yet.
        self._dec = None
        self._undecoded: list[bytes] = []
        # Cumulative host seconds: whole frames ("frame_s"), the inter
        # frames' motion search and mode decision ("analysis_s"), and the
        # closed loop's decode and download of the references
        # ("decode_s"); the rest of frame_s is transform, quantization,
        # trellis and packing.
        self.timing = {"frame_s": 0.0, "analysis_s": 0.0, "decode_s": 0.0}

    def flush_headers(self) -> list[Packet]:
        self.packetno = 3
        return self._fp.flush_headers()

    def set_splevel(self, lvl: int) -> None:
        """Speed level (encoder.py:324-340): 0 everything, 1 early skip,
        2 the heuristic R/D quantizer and no 4MV search, 3 the plain
        quantizer, 4 no motion compensation; 2 and more turn adaptive
        quantization off."""
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
        VP3 compatibility, speed 2 and more): (noise_like, mixed, luma
        lambda scales)."""
        if (not self.adaptive_quant or self.vp3_compatible
                or self.sp_level >= 2):
            return None
        return aq.frame_gates(np.ascontiguousarray(ycbcr[0][::-1]),
                              self.adaptive_quant, keep_noise_scales=True)

    def _qis(self, gates, qti: int) -> list:
        """The qi list a frame of type qti with these gates takes at the
        current qi (encoder.py:964-1049)."""
        if gates is None:
            return [self.qi]
        nl, mixed, sc = gates
        qis = aq.qi_triple(self.adaptive_quant, self.qi, qti,
                           int(self.info.pixel_fmt), nl, mixed,
                           sc is not None)
        return qis or [self.qi]

    def keyframe_qis(self, gates) -> list:
        """The qi list a keyframe with these gates takes."""
        return self._qis(gates, 0)

    def uses_device_tq(self, qis) -> bool:
        """Whether a keyframe with this qi list takes precomputed fDCT +
        quantization results: one qi and the trellis (encoder.py:553-566;
        a multi-qi frame runs the host's multi-qi trellis, speed levels 2
        and more the host's quantizers)."""
        return len(qis) == 1 and self.use_trellis

    # ------------------------------------------------------------------
    def encode_frame(self, ycbcr: list, e_o_s: bool = False,
                     gates=None) -> Packet:
        """Encode one frame (display-orientation planes) -> Packet
        (encoder.py:343-468).

        gates: the frame's `frame_gates(ycbcr)`, when the caller has
        them already."""
        t_frame = time.perf_counter()
        if gates is None:
            gates = self.frame_gates(ycbcr)
        self.curframe_num += 1
        self._frames_since_keyframe += 1
        if self.info.target_bitrate > 0 and self.rc is None:
            self.rc = RateControl(self.info, self.keyframe_freq)
        is_key = (self._prev_orig is None
                  or self._frames_since_keyframe >= self.keyframe_freq)
        if self.rc is not None and self.rc.twopass == 2:
            # Pass 2 replays pass 1's keyframe positions
            # (rc.twopass_force_kf; encode.c:1753-1764).
            is_key = self._prev_orig is None or self.rc.twopass_force_kf
        if is_key:
            self._frames_since_keyframe = 0
        planes = [p[::-1].astype(np.uint8) for p in ycbcr]
        if self.rc is not None:
            self.qi = self.rc.select_qi(
                INTRA_FRAME if is_key else INTER_FRAME, self.qi,
                frames_since_kf=self._frames_since_keyframe)
        if is_key:
            data = self._keyframe(planes, gates)
        else:
            data = self._encode_inter(planes, gates)
            # Scene-cut fallback: an inter frame at least as big as the
            # last keyframe is encoded again as a keyframe
            # (analyze.c:2690-2711).
            if self._last_kf_size and len(data) >= self._last_kf_size:
                is_key = True
                self._frames_since_keyframe = 0
                data = self._keyframe(planes, gates)
        dropped = False
        if self.rc is not None:
            # Post-encode drop decision: an inter frame that busts the
            # budget becomes a 0-byte dup (or an explicit VP3 drop frame),
            # and the references stay put (rate.c:825-832,
            # encode.c:1259-1271).
            dropped = self.rc.update(
                INTRA_FRAME if is_key else INTER_FRAME, self.qi,
                len(data) * 8, droppable=not is_key)
            if dropped:
                data = self._drop_frame_pack() if self.vp3_compatible \
                    else b""
        if is_key and not dropped:
            self._last_kf_size = len(data)
        self._prev_orig = planes
        if is_key:
            self._gold_orig = planes
            # A keyframe sets both references: older packets need no
            # decode.
            self._undecoded = []
        self._undecoded.append(data)
        shift = self.info.keyframe_granule_shift
        self.granpos = ((self.keyframe_num + 1) << shift) + (
            self.curframe_num - self.keyframe_num)
        pkt = Packet(data, granulepos=self.granpos, packetno=self.packetno,
                     e_o_s=e_o_s)
        self.packetno += 1
        self.timing["frame_s"] += time.perf_counter() - t_frame
        return pkt

    def _drop_frame_pack(self) -> bytes:
        """Explicit drop frame: an inter frame that codes no block, at the
        frame's qi (encode.c:875-906; encoder.py:471-491)."""
        nsbs = self.geometry.nsbs
        bw = BitWriter()
        bw.write(0, 1)
        bw.write(1, 1)          # inter
        bw.write(self.qi, 6)
        bw.write(0, 1)
        # No partially coded super blocks, then no fully coded ones.
        bw.write(0, 1)
        sb_run_pack(bw, nsbs, 0, True)
        bw.write(0, 1)
        sb_run_pack(bw, nsbs, 0, True)
        # Mode scheme 7 (no modes to code), MV scheme 1.
        bw.write(7, 3)
        bw.write(1, 1)
        # DC and AC Huffman table choices (no token follows).
        for _ in range(4):
            bw.write(0, 4)
        return bw.bytes()

    def _keyframe(self, planes, gates) -> bytes:
        # GOP-local trellis cost model, so that GOP-parallel encoding is
        # byte-identical to sequential (encoder.py:377-379).
        self._huff_pred = [[0, 0], [0, 0]]
        data = self._encode_intra(planes, gates)
        self.keyframe_num = self.curframe_num
        return data

    def _references(self):
        """The closed loop's (prev, gold) references, three padded uint8
        planes each in bitstream orientation: the decoder on the card
        decodes the final packets it has not seen, then hands its
        references over once."""
        t0 = time.perf_counter()
        if self._dec is None:
            books = [Codebook([(t, p, n) for t, (p, n) in enumerate(tb)])
                     for tb in self.huff_codes]
            setup = SetupInfo(qinfo=self._fp.qinfo, codebooks=books)
            self._dec = PacketDecoder(self.info, setup, self.device)
        for data in self._undecoded:
            self._dec.decode_packet(data)
        self._undecoded = []
        refs = self._dec.reference_planes()
        self.timing["decode_s"] += time.perf_counter() - t0
        return refs

    # ------------------------------------------------------------------
    def _select_adaptive_qis(self, gates, qti: int):
        """The frame's qi list and, with the triple, the per-fragment qii
        array the multi-qi trellis fills (encoder.py:1122-1177)."""
        self._frame_qis = None
        self._frag_lam_scale = None
        qis = self._qis(gates, qti)
        if len(qis) == 1:
            return None
        if not self.use_trellis:
            raise NotImplementedError(
                "adaptive quantization's qi triple without the trellis "
                "(use_trellis=False at speed levels 0-1) is not ported")
        g = self.geometry
        nl, _, sc = gates
        self._aq_scale_frame = aq.chooser_lambda_scale(
            self.adaptive_quant, self.qi, qti, int(self.info.pixel_fmt), nl,
            self.aq_lambda_scale)
        if sc is not None:
            full = np.ones(g.nfrags, np.float64)
            full[:g.planes[0].nfrags] = sc
            self._frag_lam_scale = full
        self._frame_qis = qis
        self._frag_qii_rd = np.zeros(g.nfrags, dtype=np.int32)
        return self._frag_qii_rd

    def _encode_intra(self, planes, gates) -> bytes:
        self._cur_fti = 0
        g = self.geometry
        frag_qii = self._select_adaptive_qis(gates, 0)
        qis = self.frame_qis
        pre = None
        if self.device_tq is not None and self.uses_device_tq(qis):
            pre = self.device_tq(planes, qis[0])
        coded = np.zeros(g.nfrags, dtype=bool)
        coded[g.scan_fragis] = True
        frag_refi = np.full(g.nfrags, FRAME_SELF, dtype=np.int32)

        def residual(pli, fragis):
            # Every block of a keyframe is coded: raster order.
            pl = g.planes[pli]
            h, w = pl.nvfrags * 8, pl.nhfrags * 8
            return (planes[pli][:h, :w]
                    .reshape(pl.nvfrags, 8, pl.nhfrags, 8)
                    .transpose(0, 2, 1, 3).reshape(-1, 8, 8)
                    .astype(np.int32) - 128)

        per_plane = self._transform_quantize(coded, frag_refi, residual, pre)
        ordered = self._dc_predict_and_order(per_plane, coded, frag_refi)
        bw = BitWriter()
        self._fp._frame_header_pack(bw, INTRA_FRAME, qis)
        if frag_qii is not None:
            self._fp._block_qis_pack(bw, qis, frag_qii, coded)
        return self._pack(bw, ordered)

    # ------------------------------------------------------------------
    def _transform_quantize(self, coded, frag_refi, residual_fn, pre=None):
        """fDCT + quantization of the coded blocks of each plane: per
        plane (fragis, qdct [n, 64] int32 zig-zag with the quantized DC,
        err2 [n], res2 [n] or None, dct16 [n, 64] or None, qti [n], the
        trellis plans [n, 66, 4] int16 or None, their AC bits [n] or
        None), blocks in raster order (encoder.py:512-687).

        residual_fn(pli, fragis) -> [n, 8, 8] int32 residual blocks; pre:
        a keyframe's device-computed {pli: (dct16, qdct)}."""
        g = self.geometry
        qis = self.frame_qis
        trellis = self.use_trellis
        out = []
        for pli in range(3):
            pl = g.planes[pli]
            sl = slice(pl.froffset, pl.froffset + pl.nfrags)
            fragis = np.flatnonzero(coded[sl]) + pl.froffset
            n = len(fragis)
            qti = (frag_refi[fragis] != FRAME_SELF).astype(np.int32)
            if n == 0:
                # F6: empty plans (and nothing else) on every frame with
                # the trellis.
                out.append((fragis, np.zeros((0, 64), np.int32),
                            np.zeros(0, np.int64), np.zeros(0, np.int64),
                            None, qti,
                            np.zeros((0, 66, 4), np.int16) if trellis
                            else None,
                            np.zeros(0, np.int64) if trellis else None))
                continue
            if pre is not None:
                # Device-computed fDCT + quantization (encoder.py:565-586):
                # raster order == fragis order on a keyframe.
                local = fragis - pl.froffset
                dct16 = np.ascontiguousarray(pre[pli][0][local])
                qdct = pre[pli][1][local].astype(np.int32)
                err2 = np.zeros(n, np.int64)
                paths, acbits = self._trellis_plan_blocks(
                    pli, qdct, dct16, qti, err2)
                out.append((fragis, qdct, err2, None, dct16, qti, paths,
                            acbits))
                continue
            res = residual_fn(pli, fragis)
            if trellis and len(qis) > 1:
                out.append(self._tq_trellis_multi_qi(pli, fragis, res, qti,
                                                     qis))
                continue
            qdct = np.empty((n, 64), dtype=np.int32)
            err2 = np.zeros(n, dtype=np.int64)
            res2 = np.zeros(n, dtype=np.int64)
            dct16 = np.empty((n, 64), dtype=np.int16) if trellis else None
            for t in (0, 1):
                m = qti == t
                if not m.any():
                    continue
                dq = self.dequant[qis[0], pli, t]
                lam = rd_lambda(qis[0], int(dq[1])) * self.rd_strength
                if trellis:
                    qz, e2, r2, d16 = fdct_quantize_rd_native(
                        res[m], dq, lam, rd=False, want_dct=True)
                    dct16[m] = d16
                else:
                    qz, e2, r2 = fdct_quantize_rd_native(
                        res[m], dq, lam, rd=self.rd_quant)
                qdct[m] = qz
                err2[m] = e2
                res2[m] = r2
            paths = acbits = None
            if trellis:
                paths, acbits = self._trellis_plan_blocks(
                    pli, qdct, dct16, qti, err2)
            out.append((fragis, qdct, err2, res2, dct16, qti, paths,
                        acbits))
        return out

    def _tq_trellis_multi_qi(self, pli, fragis, res, qti, qis):
        """fDCT once, then quantization and a trellis plan per qi row;
        each block's qii by exact R/D cost, err2 + lambda (acbits +
        signalling). DC always quantizes with qis[0] (decode.c:1530).
        encoder.py:690-853 with its estimate pass off (the default
        aq_estimate_margin None)."""
        n = len(fragis)
        fti = self._cur_fti
        lam = (RD_LAMBDA.get(int(self.info.pixel_fmt), RD_LAMBDA[0])[fti][
            qis[0]] * self._aq_scale_frame)
        scale = self._frag_lam_scale
        lam_b = lam * scale[fragis] if scale is not None else lam
        nbt = self._nb_table(pli, fti)
        qdct0 = np.empty((n, 64), dtype=np.int16)
        dct16 = np.empty((n, 64), dtype=np.int16)
        for t in (0, 1):
            m = qti == t
            if m.any():
                qz, _, _, d16 = fdct_quantize_rd_native(
                    res[m], self.dequant[qis[0], pli, t], 0.0, rd=False,
                    want_dct=True)
                qdct0[m] = qz
                dct16[m] = d16
        dq0 = self.dequant[qis[0], pli]
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
                qtis = np.ascontiguousarray(qti[idx])
                qsub = np.empty((len(idx), 64), dtype=np.int16)
                for t in (0, 1):
                    m = qtis == t
                    if not m.any():
                        continue
                    qsub[m] = _quantize(d16c[m], self.dequant[qi, pli, t])
                    qsub[m, 0] = _quantize(
                        d16c[m][:, :1],
                        self.dequant[qis[0], pli, t][:1]).reshape(-1)
                dq = self.dequant[qi, pli]
                p_s, a_s, e_s = trellis_plan_blocks_native(
                    d16c, qsub, dq[0], dq[1], qtis,
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
        self._frag_qii_rd[fragis] = best
        res2 = (res.astype(np.int64) ** 2).reshape(n, -1).sum(axis=1) * 16
        return (fragis, np.stack(qdcts)[best, rows].astype(np.int32),
                np.stack(err2s)[best, rows], res2, dct16, qti,
                np.stack(pathss)[best, rows], np.stack(acbitss)[best, rows])

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

    def _trellis_plan_blocks(self, pli, qdct, dct16, qti, err2):
        """Plan every block at the frame's base qi and lambda; rewrites
        the AC values of qdct and err2 in place. Returns (plans, AC
        bits)."""
        fti = self._cur_fti
        qi0 = self.frame_qis[0]
        lam = RD_LAMBDA.get(int(self.info.pixel_fmt), RD_LAMBDA[0])[fti][qi0]
        qd16 = np.ascontiguousarray(qdct, dtype=np.int16)
        dq = self.dequant[qi0, pli]
        paths, acbits, e2 = trellis_plan_blocks_native(
            dct16, qd16, dq[0], dq[1], qti, lam, self._nb_table(pli, fti))
        qdct[:] = qd16
        err2[:] = e2
        return paths, acbits

    # ------------------------------------------------------------------
    def _encode_inter(self, planes, gates) -> bytes:
        """Inter frame: luma ME on the original references, the mode
        decision with its fragment fill, then the tail
        (encoder.py:1384-1550, the native path)."""
        t0 = time.perf_counter()
        self._cur_fti = 1
        g = self.geometry
        cur_y = planes[0]
        prev_o = _pad_plane(self._prev_orig[0])
        gold_o = _pad_plane(self._gold_orig[0])
        mb_list = np.flatnonzero(g.mb_valid)
        nmb = len(mb_list)
        # MB top-left in luma pixels: from the MB's block 0 fragment.
        mb_fy = g.frag_y[g.mb_maps[mb_list, 0, 0]] * 8
        mb_fx = g.frag_x[g.mb_maps[mb_list, 0, 0]] * 8
        sp = self.sp_level
        if sp >= 4:
            # No motion search at all (OC_SP_LEVEL_NOMC, encint.h:224).
            full_mvs = np.zeros((nmb, 2), np.int32)
            mvs = np.zeros((nmb, 2), np.int32)
            sad_mv = None
        else:
            mvs, sad_mv = motion_estimate_native(cur_y, prev_o, mb_fy, mb_fx)
            full_mvs = (mvs // 2).astype(np.int32)
        zz = np.zeros(nmb, np.int32)
        sad_nomv = sad_batch_native(cur_y, prev_o, mb_fy, mb_fx, zz, zz)
        sad_gold = sad_batch_native(cur_y, gold_o, mb_fy, mb_fx, zz, zz)
        # Crude intra cost: deviation from the integer block means.
        ay = mb_fy[:, None, None] + np.arange(16)[None, :, None]
        ax = mb_fx[:, None, None] + np.arange(16)[None, None, :]
        b8 = (cur_y[ay, ax].astype(np.int32)
              .reshape(nmb, 2, 8, 2, 8).transpose(0, 1, 3, 2, 4)
              .reshape(nmb, 4, 64))
        sad_intra = (np.abs(b8 - (b8.sum(axis=2, keepdims=True) >> 6))
                     .sum(axis=(1, 2)).astype(np.int64))
        if sad_mv is None:
            sad_mv = sad_nomv.copy()
        if sp >= 2:
            # No per-block 4MV search; the mode is priced out.
            bmvs = np.zeros((nmb, 4, 2), np.int32)
            sad_4mv = np.full(nmb, _NO_SAD)
            if sp >= 4:
                sad_mv = np.full(nmb, _NO_SAD)
        else:
            blk_off = np.array([(0, 0), (0, 8), (8, 0), (8, 8)])
            blk_fy = (mb_fy[:, None] + blk_off[None, :, 0]).reshape(-1)
            blk_fx = (mb_fx[:, None] + blk_off[None, :, 1]).reshape(-1)
            seed = np.stack([np.repeat(full_mvs[:, 0], 4),
                             np.repeat(full_mvs[:, 1], 4)], axis=1)
            bmvs, bsad = me_block_refine_native(cur_y, prev_o, blk_fy,
                                                blk_fx, seed, bs=8)
            sad_4mv = bsad.reshape(nmb, 4).sum(axis=1)
            bmvs = bmvs.reshape(nmb, 4, 2)
        # Mode-decision rate biases are calibrated at qi 40 and scale with
        # the quantizer step (analyze.c:1063-1076 in spirit).
        bias_scale = min(1.0, float(self.dequant[self.qi, 0, 1, 1])
                         / float(self.dequant[40, 0, 1, 1]))
        mb_modes_n, mb_mvs_n, frag_refi, frag_mode, frag_mv = \
            mode_decide_fill_native(
                cur_y, prev_o, mb_list, mb_fy, mb_fx, sad_nomv, sad_gold,
                sad_intra, sad_mv, sad_4mv, mvs, bmvs.reshape(-1, 2),
                g.mb_maps, int(self.info.pixel_fmt),
                28 * int(self.rd_strength * 4 + 4) * bias_scale, g.nfrags,
                bias_scale=bias_scale)
        mb_modes = np.zeros(g.nmbs, dtype=np.int32)
        mb_modes[~g.mb_valid] = -1
        mb_modes[mb_list] = mb_modes_n
        mb_mvs = np.zeros((g.nmbs, 2), dtype=np.int32)
        mb_mvs[mb_list] = mb_mvs_n
        self._frag_mv4 = frag_mv
        self.timing["analysis_s"] += time.perf_counter() - t0
        return self._encode_inter_tail(planes, gates, frag_refi, frag_mode,
                                       frag_mv, mb_modes, mb_mvs)

    def _encode_inter_tail(self, planes, gates, frag_refi, frag_mode,
                           frag_mv, mb_modes, mb_mvs) -> bytes:
        """Residuals against the reconstructed references, transform,
        quantization, the early and R/D skips (encoder.py:1902-2125 with
        coupled_skip and luma_ext_skip off)."""
        g = self.geometry
        fmt = int(self.info.pixel_fmt)
        prev_rec, gold_rec = self._references()

        def residual(pli, fragis):
            vpad, hpad = g.plane_padding(pli)
            qpx = 1 if (pli != 0 and not (fmt & 1)) else 0
            qpy = 1 if (pli != 0 and not (fmt & 2)) else 0
            refi = frag_refi[fragis]
            refsel = np.where(refi == FRAME_SELF, 0,
                              np.where(refi == FRAME_GOLD, 2, 1))
            dx = frag_mv[fragis, 0] + 31
            dy = frag_mv[fragis, 1] + 31
            mx, mx2 = MVMAP[qpx][dx], MVMAP2[qpx][dx]
            my, my2 = MVMAP[qpy][dy], MVMAP2[qpy][dy]
            use2 = ((mx2 != 0) | (my2 != 0)) & (refsel != 0)
            return enc_residuals_native(
                planes[pli], prev_rec[pli], gold_rec[pli],
                g.frag_y[fragis] * 8, g.frag_x[fragis] * 8, refsel, my, mx,
                my + my2, mx + mx2, use2, vpad, hpad)

        coded = np.zeros(g.nfrags, dtype=bool)
        coded[g.scan_fragis] = True
        coded &= frag_refi != FRAME_NONE
        # One quantizer at speed levels 2 and more (FAST_ANALYSIS).
        frag_qii = (self._select_adaptive_qis(gates, 1)
                    if self.sp_level < 2 else None)
        lam = (rd_lambda(self.qi, int(self.dequant[self.qi, 0, 1, 1]))
               * self.rd_strength * 4.0 * _SKIP_LAMBDA_SCALE)
        if self.sp_level >= 1:
            # Early skip (OC_SP_LEVEL_EARLY_SKIP, analyze.c:708-715): a
            # block whose uncoded SSD cannot beat any coded version skips
            # the transform; level 1 keeps the stream unchanged, higher
            # levels widen the threshold.
            thresh = np.int64(lam * 2.0 * (1.0 if self.sp_level == 1
                                           else 4.0))
            for pli in range(3):
                pl = g.planes[pli]
                sl = slice(pl.froffset, pl.froffset + pl.nfrags)
                cand = coded[sl].copy()
                if pli == 0:
                    cand &= frag_mode[sl] == MODE_INTER_NOMV
                if not cand.any():
                    continue
                unc = self._uncoded_ssd_plane(planes, prev_rec, pli)
                coded[np.flatnonzero(cand & (unc <= thresh))
                      + pl.froffset] = False
        per_plane = self._transform_quantize(coded, frag_refi, residual)
        # R/D skip (analyze.c:859-867): a luma NOMV block, or a chroma
        # block of any mode, stays uncoded when coding it does not beat
        # the uncoded copy from the previous frame by its bit cost.
        for pli in range(3):
            fragis, qdct, err2, res2, _, _, paths, acbits = per_plane[pli]
            if len(fragis) == 0:
                continue
            bits_est = (acbits + 2 if paths is not None
                        else 6 * (qdct != 0).sum(axis=1) + 2)
            cost = err2 + (lam * bits_est).astype(np.int64)
            if pli == 0:
                skip = (res2 <= cost) & (frag_mode[fragis] == MODE_INTER_NOMV)
            else:
                unc = self._uncoded_ssd_plane(planes, prev_rec, pli)
                skip = unc[fragis - g.planes[pli].froffset] <= cost
            if skip.any():
                keep = ~skip
                coded[fragis[skip]] = False
                per_plane[pli] = tuple(None if a is None else a[keep]
                                       for a in per_plane[pli])
        return self._finish_inter(per_plane, coded, frag_refi, frag_qii,
                                  mb_modes, mb_mvs)

    def _finish_inter(self, per_plane, coded, frag_refi, frag_qii,
                      mb_modes, mb_mvs) -> bytes:
        """DC prediction, the frame header, coded flags, modes, vectors,
        qi indices and tokens (encoder.py:2128-2170); a frame that codes
        no block is a 0-byte dup packet, or with vp3_compatible a drop
        frame (encode.c:865-906, 926-928)."""
        g = self.geometry
        if not coded.any():
            return self._drop_frame_pack() if self.vp3_compatible else b""
        # Uncoded fragments keep FRAME_NONE so DC prediction skips them.
        frag_refi[~coded] = FRAME_NONE
        ordered = self._dc_predict_and_order(per_plane, coded, frag_refi)
        fp = self._fp
        bw = BitWriter()
        fp._frame_header_pack(bw, INTER_FRAME, self.frame_qis)
        fp._coded_flags_pack(bw, coded)
        lum = g.mb_maps[:, 0, :]
        has = (lum >= 0) & coded[np.clip(lum, 0, None)]
        coded_mbis = list(np.flatnonzero(has.any(axis=1) & g.mb_valid))
        fp._mb_modes_pack(bw, mb_modes, coded_mbis)
        fp._mvs_pack(bw, mb_modes, mb_mvs, coded_mbis, coded, self._frag_mv4)
        if frag_qii is not None:
            fp._block_qis_pack(bw, self.frame_qis, frag_qii, coded)
        return self._pack(bw, ordered)

    def _uncoded_ssd_plane(self, planes, prev_rec, pli):
        """Per-fragment SSD (x16, the DCT domain) of the uncoded
        prediction, a zero-MV copy from the reconstructed previous frame
        (analyze.c:529-531 skip_ssd; encoder.py:2206)."""
        pl = self.geometry.planes[pli]
        vpad, hpad = self.geometry.plane_padding(pli)
        return ssd8_plane_native(planes[pli][:pl.nvfrags * 8,
                                             :pl.nhfrags * 8],
                                 prev_rec[pli], vpad, hpad)

    # ------------------------------------------------------------------
    def _dc_predict_and_order(self, per_plane, coded, frag_refi):
        """DC-predict every plane (raster order) and order the coded
        blocks in coded (scan) order (encoder.py:1318-1381). With trellis
        plans: per plane (plans, scan -> raster permutation, scan-order DC
        residuals); without: per plane [n, 64] int16 vectors with the DC
        residual at 0."""
        g = self.geometry
        out = []
        for pli in range(3):
            fragis, qdct = per_plane[pli][:2]
            paths = per_plane[pli][6]
            pl = g.planes[pli]
            shape = (pl.nvfrags, pl.nhfrags)
            sl = slice(pl.froffset, pl.froffset + pl.nfrags)
            local = fragis - pl.froffset
            dc = np.zeros(pl.nfrags, dtype=np.int32)
            dc[local] = qdct[:, 0]
            dc_resid = dc_residuals_native(
                coded[sl].reshape(shape), frag_refi[sl].reshape(shape),
                dc.reshape(shape), [0, 0, 0]).reshape(-1)
            scan = g.scan_fragis[g.scan_pli == pli]
            scan = scan[coded[scan]] - pl.froffset
            if paths is not None:
                out.append((paths,
                            np.searchsorted(local, scan).astype(np.int32),
                            dc_resid[scan].astype(np.int32)))
            else:
                vecs = np.zeros((pl.nfrags, 64), dtype=np.int16)
                vecs[local] = qdct
                vecs = vecs[scan]
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
            self._huff_pred[self._cur_fti] = chosen[2:]
            return pkt
        return self._fp._packer.pack_frame(
            np.concatenate(ordered), [len(v) for v in ordered], bw.bytes(),
            bw.bitpos)
