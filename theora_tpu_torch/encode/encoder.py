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
`_pad_plane` and the token packing; the settings off its defaults:
`auto_keyframe`, `skip_lambda_scale`, `luma_ext_skip` with its guard,
`coupled_skip` (`_coupled_transform_skip`, the luma-first coupled mode/skip
rollback, and its four tunables), `aq_estimate_margin` (the estimate-first
qii of finer rows) and, with `use_trellis=False`, the qi triple's activity
terciles; the SATD + fitted-table mode
decision of mode_rd (`_mode_decide_rd`, encode/modedec.py, with the
per-fragment fill of its plan, `_fill_fragments`) and the R-D metrics of
collect (`_collect_frame_metrics`). Headers, the frame header, the coded
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
needs none of the JAX decoder's rewinds (encoder.py:383-404). Under
collect the decoder decodes each frame's packet at once, with the bits of
each fragment's tokens, and the frame's rows read its reconstruction.

A dropped frame is a 0-byte packet (or, with vp3_compatible, an inter
frame that codes no block); the closed loop decodes it like any final
packet, so its references stay put, as the JAX Encoder's do.
vp3_compatible also turns adaptive quantization off and makes an inter
frame that codes no block a drop frame.

Left out (ROADMAP section 1): fast_recon and the pack/recon overlap
thread, which the closed loop on the card replaces.

Fault F6 of the reference, not copied: where a plane of a multi-qi frame
has no block left to code before the transform (the early skip of speed
1), the JAX Encoder keeps no trellis plans for it, so a later plane's
plans and its columns cannot be packed together (ROADMAP section 3); the
port gives the plane empty plans, as on a one-qi frame.

Fault F12 of the reference, not copied: JAX's mode_rd at speed levels 2-4
reads the 4MV search's block coordinates, which only levels 0-1 compute,
and raises UnboundLocalError (encoder.py:1484-1486,1594); the port
computes them at every level, so mode_rd prices 4MV with zero vectors
there, as the JAX decision does with the zero bmvs of those levels.

Fault F13 of the reference, not copied: the 4MV block refinement can
return a -32 half-pel component (its seed, the MB vector halved, reaches
-16 full-pel), which the MV code cannot carry; JAX's mode_rd then raises
KeyError pricing its bits (encoder.py:1856). The port leaves 4MV out of
the candidates of an MB whose block vectors hold such a component, for
any mode_rd_seed_levels and mode_rd_rate_scale.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from theora_tpu_torch import resolve_device
from theora_tpu_torch.bitio import BitWriter
from theora_tpu_torch.constants import (
    DCT_TOKEN_EXTRA_BITS,
    FRAME_FOR_MODE,
    FRAME_GOLD,
    FRAME_NONE,
    FRAME_PREV,
    FRAME_SELF,
    MODE_GOLDEN_NOMV,
    MODE_INTER_MV,
    MODE_INTER_MV_FOUR,
    MODE_INTER_MV_LAST,
    MODE_INTER_MV_LAST2,
    MODE_INTER_NOMV,
    MODE_INTRA,
    MVMAP,
    MVMAP2,
)
from theora_tpu_torch.decode.scalar import PacketDecoder
from theora_tpu_torch.encode import aq, modedec
from theora_tpu_torch.encode.packer import (  # noqa: F401
    FramePacker,
    block_run_pack,
    sb_run_pack,
)
from theora_tpu_torch.encode.rate import RateControl
from theora_tpu_torch.headers import SetupInfo
from theora_tpu_torch.huffman import MV_VLC_BOOK, Codebook
from theora_tpu_torch.info import INTER_FRAME, INTRA_FRAME, TheoraInfo
from theora_tpu_torch.native import (
    dc_residuals_native,
    enc_residuals_native,
    fdct_quantize_rd_native,
    hadamard_batch_native,
    me_block_refine_native,
    mode_decide_fill_native,
    motion_estimate_native,
    quantize_estimate_native,
    sad_batch_native,
    satd_halfpel_batch_native,
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
# The luma modes luma_ext_skip may skip; those whose macroblocks the
# coupled skip may roll back whole (they leave the decoder's vector
# predictors as they are); those whose macroblocks keep a coded luma block
# (they move the predictors).
_EXT_SKIP_MODES = (MODE_INTER_NOMV, MODE_INTER_MV, MODE_INTER_MV_LAST,
                   MODE_INTER_MV_LAST2)
_ROLLBACK_MODES = (MODE_INTER_NOMV, MODE_GOLDEN_NOMV, MODE_INTRA,
                   MODE_INTER_MV_LAST)
_GUARD_MODES = (MODE_INTER_MV, MODE_INTER_MV_LAST2, MODE_INTER_MV_FOUR)


def _quantize(dct: np.ndarray, dq: np.ndarray) -> np.ndarray:
    """Round-to-nearest quantizer, ties away from zero
    (enquant.c:220-249); int64."""
    d = dq.astype(np.int64)
    v2 = np.abs(dct.astype(np.int64)) << 1
    q = np.where(v2 >= d, (v2 + d) // (2 * d), 0)
    return np.sign(dct) * q


def _pad_plane(plane: np.ndarray, pad: int = 16) -> np.ndarray:
    return np.pad(plane, pad, mode="edge")


def _bits_est(plane_out) -> np.ndarray:
    """The skip test's bits per block of a _transform_quantize plane
    tuple: the trellis plans' AC bits + 2, else 6 per nonzero value + 2."""
    qdct, paths, acbits = plane_out[1], plane_out[6], plane_out[7]
    if paths is not None:
        return acbits + 2
    return 6 * (qdct != 0).sum(axis=1) + 2


def _apply_skip(per_plane, pli, skip, coded) -> None:
    """Drop the skipped blocks from plane pli's tuple and uncode them
    (encoder.py:2233-2251)."""
    coded[per_plane[pli][0][skip]] = False
    keep = ~skip
    per_plane[pli] = tuple(None if a is None else a[keep]
                           for a in per_plane[pli])


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
        # Skip-decision lambda multiplier on top of rd_strength * 4.
        self.skip_lambda_scale = 2.5
        # The reference's coupled mode/skip rollback (analyze.c:859-882,
        # 933-956), off by default: _coupled_transform_skip. Its tunables:
        # the lambda scale of a non-NOMV block's skip, whether such blocks
        # may skip at all, the mode and flag bits an MB rollback saves,
        # and whether MBs roll back.
        self.coupled_skip = False
        self.skip_other_scale = 0.25
        self.skip_nonnomv = True
        self.mb_skip_overhead_bits = 6.0
        self.mb_rollback = True
        # The non-coupled luma R/D skip extended from INTER_NOMV to the MV,
        # LAST and LAST2 modes against the true uncoded SSD, off by
        # default (encoder.py:2053-2081).
        self.luma_ext_skip = False
        self.use_trellis = True
        self.sp_level = 0
        # AC Huffman indices of the last packed frame of each type, the
        # trellis' cost model (encode.c:838-858 carry).
        self._huff_pred = [[0, 0], [0, 0]]
        self._nb_cache = {}
        self._cur_fti = 0
        self.adaptive_quant = "auto"
        self.aq_lambda_scale = 1.0
        # Estimate-first qii: None, or a margin in bits; a finer row then
        # runs the exact trellis only on the blocks whose cheap estimate
        # comes within that many lambda-bits of beating the base row
        # (encoder.py:740-803).
        self.aq_estimate_margin = None
        self._frame_qis = None
        # Each fragment's index into the frame's qi list: chosen by the
        # multi-qi trellis, or by luma activity without the trellis.
        self._frag_qii = None
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
        # R-D metrics collection (collect.c analogue): None, or a list to
        # which each frame appends an [n, 7] int64 array, one row (qi,
        # pli, qti, satd, bits, ssd, ctx) per coded fragment in token
        # order (encoder.py:151-153, 2487-2540).
        self.collect = None
        # The SATD + fitted-table mode decision (encoder.py:154-177): off
        # by default; the rate multiplier on its lambda; the MV-bit
        # discounts of its seeded walks (the cheapest full-price plan
        # wins).
        self.mode_rd = False
        self.mode_rd_rate_scale = 1.0
        self.mode_rd_seed_levels = (1.0, 0.25, 0.0)
        self._mv_len = None
        self.rc = None
        self.curframe_num = -1
        self.keyframe_num = 0
        self.packetno = 0
        self.keyframe_freq = 64
        self._frames_since_keyframe = -1
        self.granpos = -1
        # The scene-cut fallback: an inter frame at least as big as the
        # last keyframe is encoded again as a keyframe.
        self.auto_keyframe = True
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
        # The references as the host last downloaded them; None once a
        # packet is queued for the decoder.
        self._refs_host = None
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
        if self.collect is not None:
            # Each block's SATD and qti as the last transform of the frame
            # left them (encoder.py:372-375).
            self._satd_frame = np.zeros(self.geometry.nfrags, np.int64)
            self._qti_frame = np.zeros(self.geometry.nfrags, np.int32)
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
            if (self.auto_keyframe and self._last_kf_size
                    and len(data) >= self._last_kf_size):
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
        self._refs_host = None
        if self.collect is not None:
            # Decode the frame at once, with its bits per fragment, and
            # read its reconstruction (encoder.py:431-445).
            refs = self._references(want_bits=True)
            if len(data):
                self._collect_frame_metrics(planes, refs[0])
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

    def _references(self, want_bits: bool = False):
        """The closed loop's (prev, gold) references, three padded uint8
        planes each in bitstream orientation: the decoder on the card
        decodes the final packets it has not seen, then hands its
        references over once per decoded frame. want_bits: the decoder
        keeps each fragment's token bits (collect)."""
        if self._refs_host is not None:
            return self._refs_host
        t0 = time.perf_counter()
        if self._dec is None:
            books = [Codebook([(t, p, n) for t, (p, n) in enumerate(tb)])
                     for tb in self.huff_codes]
            setup = SetupInfo(qinfo=self._fp.qinfo, codebooks=books)
            self._dec = PacketDecoder(self.info, setup, self.device)
        self._dec.want_frag_bits = want_bits
        for data in self._undecoded:
            self._dec.decode_packet(data)
        self._undecoded = []
        self._refs_host = self._dec.reference_planes()
        self.timing["decode_s"] += time.perf_counter() - t0
        return self._refs_host

    def _collect_frame_metrics(self, planes, recon) -> None:
        """Append the frame's rows to self.collect, one per coded
        fragment in token order: (qi, pli, qti, satd, bits, ssd, ctx),
        ssd the reconstruction's pixel SSD and ctx the mean of the left
        and upper neighbours' SATDs (encoder.py:2487-2540)."""
        dec = self._dec
        order = dec._last_token_order
        bits = dec._frag_bits
        if order is None or bits is None or len(order) == 0:
            return
        g = self.geometry
        ssd_full = np.zeros(g.nfrags, dtype=np.int64)
        ctx = np.zeros(g.nfrags, dtype=np.int64)
        for pli in range(3):
            pl = g.planes[pli]
            vpad, hpad = g.plane_padding(pli)
            h, w = pl.nvfrags * 8, pl.nhfrags * 8
            d = (planes[pli].astype(np.int64)
                 - recon[pli][vpad:vpad + h, hpad:hpad + w])
            sl = slice(pl.froffset, pl.froffset + pl.nfrags)
            ssd_full[sl] = ((d * d).reshape(pl.nvfrags, 8, pl.nhfrags, 8)
                            .sum(axis=(1, 3)).reshape(-1))
            s = self._satd_frame[sl].reshape(pl.nvfrags, pl.nhfrags)
            left = np.zeros_like(s)
            left[:, 1:] = s[:, :-1]
            up = np.zeros_like(s)
            up[1:, :] = s[:-1, :]
            ctx[sl] = ((left + up) // 2).reshape(-1)
        self.collect.append(np.stack([
            np.full(len(order), self.qi, dtype=np.int64),
            np.repeat(np.arange(3, dtype=np.int64),
                      [pl.nfrags for pl in g.planes])[order],
            self._qti_frame[order].astype(np.int64),
            self._satd_frame[order],
            bits[:len(order)].astype(np.int64),
            ssd_full[order],
            ctx[order],
        ], axis=1))

    # ------------------------------------------------------------------
    def _select_adaptive_qis(self, planes, gates, qti: int):
        """The frame's qi list and, with the triple, the per-fragment qii
        array: filled by the multi-qi trellis, or without the trellis
        from luma block variance (encoder.py:1122-1177)."""
        self._frame_qis = None
        self._frag_lam_scale = None
        qis = self._qis(gates, qti)
        if len(qis) == 1:
            return None
        g = self.geometry
        if not self.use_trellis:
            # Activity terciles: the calmest tenth of the luma blocks takes
            # the finer qi and those from the 55th percentile on the
            # coarser, where each is in the list; chroma keeps the base.
            coarser = next((i for i in range(1, len(qis))
                            if qis[i] < qis[0]), 0)
            finer = next((i for i in range(1, len(qis))
                          if qis[i] > qis[0]), 0)
            y = planes[0]
            h, w = y.shape
            var = (y.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3)
                   .reshape(-1, 64).astype(np.float64).var(axis=1))
            lo, hi = np.quantile(var, [0.10, 0.55])
            self._frag_qii = np.zeros(g.nfrags, dtype=np.int32)
            self._frag_qii[:g.planes[0].nfrags] = np.where(
                var <= lo, finer, np.where(var >= hi, coarser, 0))
            self._frame_qis = qis
            return self._frag_qii
        nl, _, sc = gates
        self._aq_scale_frame = aq.chooser_lambda_scale(
            self.adaptive_quant, self.qi, qti, int(self.info.pixel_fmt), nl,
            self.aq_lambda_scale)
        if sc is not None:
            full = np.ones(g.nfrags, np.float64)
            full[:g.planes[0].nfrags] = sc
            self._frag_lam_scale = full
        self._frame_qis = qis
        self._frag_qii = np.zeros(g.nfrags, dtype=np.int32)
        return self._frag_qii

    def _encode_intra(self, planes, gates) -> bytes:
        self._cur_fti = 0
        g = self.geometry
        frag_qii = self._select_adaptive_qis(planes, gates, 0)
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
            res = None
            if self.collect is not None and n:
                # encoder.py:541-546: the SATD of the residual each coded
                # block is transformed from.
                res = residual_fn(pli, fragis)
                self._satd_frame[fragis] = hadamard_batch_native(res)[0]
                self._qti_frame[fragis] = qti
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
            if res is None:
                res = residual_fn(pli, fragis)
            if trellis and len(qis) > 1:
                out.append(self._tq_trellis_multi_qi(pli, fragis, res, qti,
                                                     qis))
                continue
            if len(qis) > 1:
                out.append(self._tq_qii_rows(pli, fragis, res, qti, qis))
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

    def _tq_qii_rows(self, pli, fragis, res, qti, qis):
        """Without the trellis, a multi-qi frame (encoder.py:632-686):
        each block's fDCT and quantization (R/D or round-to-nearest, by
        rd_quant) at the row of its qii (_select_adaptive_qis), the DC at
        qis[0] (decode.c:1530). err2 is taken against the row's
        quantizers, the DC's too, as the JAX Encoder takes it."""
        n = len(fragis)
        qiis = self._frag_qii[fragis]
        qdct = np.empty((n, 64), dtype=np.int32)
        dct = np.empty((n, 64), dtype=np.int64)
        dq_b = np.empty((n, 64), dtype=np.int64)
        for t in (0, 1):
            mt = qti == t
            for qii, qi in enumerate(qis):
                m = mt & (qiis == qii)
                if not m.any():
                    continue
                dq = self.dequant[qi, pli, t]
                lam = rd_lambda(qi, int(dq[1])) * self.rd_strength
                qz, _, _, d16 = fdct_quantize_rd_native(
                    res[m], dq, lam, rd=self.rd_quant, want_dct=True)
                qdct[m] = qz
                dct[m] = d16
                dq_b[m] = dq
            if mt.any():
                qdct[mt, 0] = _quantize(dct[mt, 0],
                                        self.dequant[qis[0], pli, t][0])
        d = dct - qdct * dq_b
        res2 = (res.astype(np.int64) ** 2).reshape(n, -1).sum(axis=1) * 16
        return (fragis, qdct, (d * d).sum(axis=1), res2, None, qti, None,
                None)

    def _tq_trellis_multi_qi(self, pli, fragis, res, qti, qis):
        """fDCT once, then quantization and a trellis plan per qi row;
        each block's qii by exact R/D cost, err2 + lambda (acbits +
        signalling). DC always quantizes with qis[0] (decode.c:1530).
        With aq_estimate_margin set, a finer row runs the trellis only on
        the blocks whose cheap estimate comes within that margin of
        beating the base row (encoder.py:690-853)."""
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
            if (len(idx) and qi > qis[0]
                    and self.aq_estimate_margin is not None):
                idx = self._estimate_winners(pli, idx, dct16, qti, qi,
                                             qis[0], lam, nbt, acbits0,
                                             err20)
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
        self._frag_qii[fragis] = best
        res2 = (res.astype(np.int64) ** 2).reshape(n, -1).sum(axis=1) * 16
        return (fragis, np.stack(qdcts)[best, rows].astype(np.int32),
                np.stack(err2s)[best, rows], res2, dct16, qti,
                np.stack(pathss)[best, rows], np.stack(acbitss)[best, rows])

    def _estimate_winners(self, pli, idx, dct16, qti, qi, qi0, lam, nbt,
                          acbits0, err20):
        """The blocks of idx whose finer row at qi, priced by the cheap
        model (th_quantize_estimate) with its bits anchored to the base
        row's exact ones, comes within aq_estimate_margin lambda-bits of
        beating the base row (encoder.py:770-803)."""
        d16 = np.ascontiguousarray(dct16[idx])
        qtis = qti[idx]
        ni = len(idx)
        bits_r = np.empty(ni, dtype=np.int64)
        err_r = np.empty(ni, dtype=np.int64)
        bits_b = np.empty(ni, dtype=np.int64)
        for t in (0, 1):
            m = qtis == t
            if not m.any():
                continue
            dq_b = self.dequant[qi0, pli, t]
            _, bits_r[m], err_r[m] = quantize_estimate_native(
                d16[m], self.dequant[qi, pli, t], int(dq_b[0]), lam, nbt)
            _, bits_b[m], _ = quantize_estimate_native(
                d16[m], dq_b, int(dq_b[0]), lam, nbt)
        est_bits = acbits0[idx] + (bits_r - bits_b)
        dcost = ((err_r + (lam * (est_bits + 1.0)).astype(np.int64))
                 - (err20[idx] + (lam * acbits0[idx]).astype(np.int64)))
        return idx[dcost < lam * float(self.aq_estimate_margin)]

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
        # Each MB's four luma blocks (F12: at every speed level).
        blk_off = np.array([(0, 0), (0, 8), (8, 0), (8, 8)])
        blk_fy = (mb_fy[:, None] + blk_off[None, :, 0]).reshape(-1)
        blk_fx = (mb_fx[:, None] + blk_off[None, :, 1]).reshape(-1)
        if sp >= 2:
            # No per-block 4MV search; the mode is priced out.
            bmvs = np.zeros((nmb, 4, 2), np.int32)
            sad_4mv = np.full(nmb, _NO_SAD)
            if sp >= 4:
                sad_mv = np.full(nmb, _NO_SAD)
        else:
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
        mb_modes = np.zeros(g.nmbs, dtype=np.int32)
        mb_mvs = np.zeros((g.nmbs, 2), dtype=np.int32)
        if self.mode_rd and modedec.tables_available():
            # encoder.py:1591-1595: the SATD + fitted-table decision in
            # place of the native one, then the fragment fill.
            self._mode_decide_rd(cur_y, prev_o, gold_o, mb_list, mvs, bmvs,
                                 blk_fy, blk_fx, mb_modes, mb_mvs)
            frag_refi, frag_mode, frag_mv = self._fill_fragments(
                mb_list, mb_modes, mb_mvs, bmvs)
        else:
            mb_modes_n, mb_mvs_n, frag_refi, frag_mode, frag_mv = \
                mode_decide_fill_native(
                    cur_y, prev_o, mb_list, mb_fy, mb_fx, sad_nomv,
                    sad_gold, sad_intra, sad_mv, sad_4mv, mvs,
                    bmvs.reshape(-1, 2), g.mb_maps,
                    int(self.info.pixel_fmt),
                    28 * int(self.rd_strength * 4 + 4) * bias_scale,
                    g.nfrags, bias_scale=bias_scale)
            mb_modes[~g.mb_valid] = -1
            mb_modes[mb_list] = mb_modes_n
            mb_mvs[mb_list] = mb_mvs_n
        self._frag_mv4 = frag_mv
        self.timing["analysis_s"] += time.perf_counter() - t0
        return self._encode_inter_tail(planes, gates, frag_refi, frag_mode,
                                       frag_mv, mb_modes, mb_mvs)

    def _fill_fragments(self, mb_list, mb_modes, mb_mvs, bmvs):
        """Each fragment's reference, mode and vector from its MB's plan;
        a 4MV MB's chroma vectors derived from its luma block vectors
        (state.c:33-97). encoder.py:1643-1692. Returns (frag_refi,
        frag_mode, frag_mv)."""
        g = self.geometry
        nfrags = g.nfrags
        frag_refi = np.full(nfrags, FRAME_NONE, dtype=np.int32)
        frag_mode = np.zeros(nfrags, dtype=np.int32)
        frag_mv = np.zeros((nfrags, 2), dtype=np.int32)

        def div_round(v, shift, rval):
            return (int(v) + (-1 if v < 0 else 0) + rval) >> shift

        pf = int(self.info.pixel_fmt)
        for i, mbi in enumerate(mb_list):
            mode = int(mb_modes[mbi])
            refi = int(FRAME_FOR_MODE[mode])
            if mode == MODE_INTER_MV_FOUR:
                lb = bmvs[i]
                for bi in range(4):
                    fragi = g.mb_maps[mbi, 0, bi]
                    if fragi >= 0:
                        frag_refi[fragi] = refi
                        frag_mode[fragi] = mode
                        frag_mv[fragi] = lb[bi]
                cb = [(0, 0)] * 4
                if pf == 0:
                    cb[0] = (div_round(int(lb[:, 0].sum()), 2, 2),
                             div_round(int(lb[:, 1].sum()), 2, 2))
                elif pf == 2:
                    for k, (a, b) in enumerate(((0, 1), (2, 3))):
                        cb[k * 2] = (
                            div_round(int(lb[a, 0] + lb[b, 0]), 1, 1),
                            div_round(int(lb[a, 1] + lb[b, 1]), 1, 1))
                else:
                    cb = [tuple(v) for v in lb]
                for pli in (1, 2):
                    for bi in range(4):
                        fragi = g.mb_maps[mbi, pli, bi]
                        if fragi >= 0:
                            frag_refi[fragi] = refi
                            frag_mode[fragi] = mode
                            frag_mv[fragi] = cb[bi]
                continue
            for pli in range(3):
                for bi in range(4):
                    fragi = g.mb_maps[mbi, pli, bi]
                    if fragi >= 0:
                        frag_refi[fragi] = refi
                        frag_mode[fragi] = mode
                        frag_mv[fragi] = mb_mvs[mbi]
        return frag_refi, frag_mode, frag_mv

    def _mode_decide_rd(self, cur_y, prev_o, gold_o, mb_list, mvs, bmvs,
                        blk_fy, blk_fx, mb_modes, mb_mvs):
        """SATD + fitted-R/D-table mode decision (analyze.c:1968-2450
        analogue over the collect-fitted tables): fills mb_modes and
        mb_mvs at mb_list. One greedy walk over the MBs per level of
        mode_rd_seed_levels; the plan whose full-price cost is least wins
        (encoder.py:1700-1900)."""
        g = self.geometry
        n = len(mb_list)
        qi = self.frame_qis[0]
        fmt = int(self.info.pixel_fmt)
        lam = float(RD_LAMBDA.get(fmt, RD_LAMBDA[0])[1][qi]) * float(
            self.mode_rd_rate_scale)
        rows = {qti: modedec.interp_rows(self.dequant, qi, qti, 0)
                for qti in (0, 1)}
        z4 = np.zeros(4 * n, np.int32)
        satd_nomv, _ = satd_halfpel_batch_native(cur_y, prev_o, blk_fy,
                                                 blk_fx, z4, z4, bs=8)
        satd_gold, _ = satd_halfpel_batch_native(cur_y, gold_o, blk_fy,
                                                 blk_fx, z4, z4, bs=8)
        ay = blk_fy[:, None, None] + np.arange(8)[None, :, None]
        ax = blk_fx[:, None, None] + np.arange(8)[None, None, :]
        satd_intra, _ = hadamard_batch_native(cur_y[ay, ax].astype(np.int32))
        mv_rep = np.repeat(mvs, 4, axis=0)
        satd_mv, _ = satd_halfpel_batch_native(
            cur_y, prev_o, blk_fy, blk_fx, mv_rep[:, 0], mv_rep[:, 1], bs=8)
        b2 = bmvs.reshape(-1, 2)
        # F13: the MV code carries -31..31 half-pel; the 4MV refinement
        # can return -32, whose MB leaves 4MV out (the SATD's table lookup
        # gets -31 in its place, never read).
        codable_4mv = (b2 > -32).all(axis=1).reshape(n, 4).all(axis=1)
        b2s = np.maximum(b2, -31)
        satd_4mv, _ = satd_halfpel_batch_native(
            cur_y, prev_o, blk_fy, blk_fx, b2s[:, 0], b2s[:, 1], bs=8)
        # The uncoded (skip) SSD against the reconstructed previous frame,
        # x16 (the tables' RMSE domain), for the NOMV MBs' skip coupling.
        prev_rec = self._references()[0][0]
        pl = g.planes[0]
        vpad, hpad = g.plane_padding(0)
        h, w = pl.nvfrags * 8, pl.nhfrags * 8
        dd = cur_y.astype(np.int64) - prev_rec[vpad:vpad + h, hpad:hpad + w]
        grid = (dd * dd).reshape(pl.nvfrags, 8, pl.nhfrags, 8).sum(
            axis=(1, 3))
        skip_ssd = 16.0 * grid[blk_fy // 8, blk_fx // 8].astype(np.float64)
        if self._mv_len is None:
            lens = {}
            for t, _p, nb in MV_VLC_BOOK.codes:
                lens.setdefault(t - 32, nb)
            self._mv_len = lens
        mv_len = self._mv_len

        def blocks_cost(satds, qti, skips, may_skip=False):
            # x16-domain distortion + lambda * bits per block; a block the
            # skip pass may drop (luma of a NOMV MB) costs the cheaper of
            # coding and skipping (analyze.c:1275-1304).
            tot = 0.0
            r_row, m_row = rows[qti]
            for sv, sk in zip(satds, skips):
                r, ssd = modedec.dct_cost(r_row, m_row, int(sv))
                c = ssd + lam * r
                if may_skip and sk < c:
                    c = sk
                tot += c
            return tot

        cur_c = np.ascontiguousarray(cur_y)
        satd_cache: dict = {}

        def last_satd(i, mvt, mv, s4):
            """SATD of MB i predicted with a LAST/LAST2 candidate vector,
            cached across walks."""
            if mvt == mv:
                return satd_mv[s4]
            key = (i, mvt)
            s_l = satd_cache.get(key)
            if s_l is None:
                mvx = np.full(4, mvt[0], np.int32)
                mvy = np.full(4, mvt[1], np.int32)
                s_l, _ = satd_halfpel_batch_native(
                    cur_c, prev_o, blk_fy[s4], blk_fx[s4], mvx, mvy, bs=8)
                satd_cache[key] = s_l
            return s_l

        def walk(seed_discount):
            """One greedy pass; seed_discount < 1 makes the MV bits of
            MV-bearing modes cheaper at decision time only (they seed the
            last-MV predictor), while the returned total is at full
            price."""
            chooser = modedec.SchemeChooser()
            last_mv = (0, 0)
            prior_mv = (0, 0)
            plan = []
            total = 0.0
            for i in range(n):
                s4 = slice(4 * i, 4 * i + 4)
                sk = skip_ssd[s4]
                mv = (int(mvs[i, 0]), int(mvs[i, 1]))
                costs = {}

                def add(mode, bc, mv_bits=0.0):
                    sc = chooser.cost(mode)
                    costs[mode] = (bc + lam * (sc + mv_bits * seed_discount),
                                   bc + lam * (sc + mv_bits))

                add(MODE_INTER_NOMV,
                    blocks_cost(satd_nomv[s4], 1, sk, may_skip=True))
                add(MODE_INTRA, blocks_cost(satd_intra[s4], 0, sk))
                add(MODE_GOLDEN_NOMV, blocks_cost(satd_gold[s4], 1, sk))
                if codable_4mv[i]:
                    add(MODE_INTER_MV_FOUR,
                        blocks_cost(satd_4mv[s4], 1, sk),
                        sum(mv_len[int(b2[4 * i + bi, 0])]
                            + mv_len[int(b2[4 * i + bi, 1])]
                            for bi in range(4)))
                if mv != (0, 0):
                    add(MODE_INTER_MV, blocks_cost(satd_mv[s4], 1, sk),
                        mv_len[mv[0]] + mv_len[mv[1]])
                for m_last, mvt in ((MODE_INTER_MV_LAST, last_mv),
                                    (MODE_INTER_MV_LAST2, prior_mv)):
                    if mvt == (0, 0) or (m_last == MODE_INTER_MV_LAST2
                                         and mvt == last_mv):
                        continue
                    add(m_last,
                        blocks_cost(last_satd(i, mvt, mv, s4), 1, sk))
                mode = min(costs, key=lambda m: costs[m][0])
                total += costs[mode][1]
                chooser.update(mode)
                if mode == MODE_INTER_MV:
                    vec = mv
                    prior_mv = last_mv
                    last_mv = mv
                elif mode == MODE_INTER_MV_LAST:
                    vec = last_mv
                elif mode == MODE_INTER_MV_LAST2:
                    vec = prior_mv
                    prior_mv, last_mv = last_mv, prior_mv
                elif mode == MODE_INTER_MV_FOUR:
                    vec = (0, 0)
                    prior_mv = last_mv
                    last_mv = (int(bmvs[i, 3, 0]), int(bmvs[i, 3, 1]))
                else:
                    vec = (0, 0)
                plan.append((mode, vec))
            return total, plan

        best_total, best_plan = None, None
        for d in self.mode_rd_seed_levels:
            total, plan = walk(d)
            if best_total is None or total < best_total:
                best_total, best_plan = total, plan
        for (mode, vec), mbi in zip(best_plan, mb_list):
            mb_modes[mbi] = mode
            mb_mvs[mbi] = vec

    def _encode_inter_tail(self, planes, gates, frag_refi, frag_mode,
                           frag_mv, mb_modes, mb_mvs) -> bytes:
        """Residuals against the reconstructed references, transform,
        quantization, the early and R/D skips, or with coupled_skip the
        coupled mode/skip rollback (encoder.py:1902-2125). residual()
        reads frag_refi and frag_mv when it is called: the rollback's mode
        forcing rewrites chroma's in place before chroma's transform."""
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
        frag_qii = (self._select_adaptive_qis(planes, gates, 1)
                    if self.sp_level < 2 else None)
        lam = (rd_lambda(self.qi, int(self.dequant[self.qi, 0, 1, 1]))
               * self.rd_strength * 4.0 * self.skip_lambda_scale)
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
        if self.coupled_skip:
            per_plane = self._coupled_transform_skip(
                planes, prev_rec, coded, frag_refi, frag_mode, frag_mv,
                mb_modes, residual, lam)
            return self._finish_inter(per_plane, coded, frag_refi, frag_qii,
                                      mb_modes, mb_mvs)
        per_plane = self._transform_quantize(coded, frag_refi, residual)
        # R/D skip (analyze.c:859-867): a luma NOMV block (with
        # luma_ext_skip, also an MV, LAST or LAST2 block, against its true
        # uncoded SSD), or a chroma block of any mode, stays uncoded when
        # coding it does not beat the uncoded copy from the previous frame
        # by its bit cost.
        for pli in range(3):
            fragis, _, err2, res2 = per_plane[pli][:4]
            if len(fragis) == 0:
                continue
            cost = err2 + (lam * _bits_est(per_plane[pli])).astype(np.int64)
            if pli == 0 and self.luma_ext_skip:
                unc = self._uncoded_ssd_plane(planes, prev_rec, 0)[fragis]
                skip = np.isin(frag_mode[fragis], _EXT_SKIP_MODES) & (
                    unc <= cost)
                self._luma_skip_guard(fragis, skip, coded, frag_mode)
            elif pli == 0:
                skip = (res2 <= cost) & (frag_mode[fragis] == MODE_INTER_NOMV)
            else:
                unc = self._uncoded_ssd_plane(planes, prev_rec, pli)
                skip = unc[fragis - g.planes[pli].froffset] <= cost
            if skip.any():
                _apply_skip(per_plane, pli, skip, coded)
        return self._finish_inter(per_plane, coded, frag_refi, frag_qii,
                                  mb_modes, mb_mvs)

    def _coupled_transform_skip(self, planes, prev_rec, coded, frag_refi,
                                frag_mode, frag_mv, mb_modes, residual, lam):
        """The coupled mode/skip R/D, luma first (encoder.py:2254-2386;
        the reference's retroactive skip with rollback,
        analyze.c:859-882, 933-956):

        1. luma's transform; each block of any mode but 4MV skips against
           its true uncoded SSD, a non-NOMV block at lambda times
           skip_other_scale (none with skip_nonnomv False), and an MV,
           LAST2 or 4MV macroblock keeps a coded luma block;
        2. with mb_rollback, a NOMV, GOLDEN_NOMV, INTRA or LAST macroblock
           (modes that leave the vector predictors as they are) drops its
           remaining luma when the uncoded SSD beats the coded one plus
           lambda times (AC bits + mb_skip_overhead_bits);
        3. a macroblock left with no coded luma becomes INTER_NOMV and its
           coded chroma predicts from the previous frame at vector 0;
        4. chroma's transform, then its skip as on the plain path.

        Returns the per-plane tuples; coded, frag_refi, frag_mode, frag_mv
        and mb_modes are updated in place."""
        g = self.geometry
        luma = np.zeros(g.nfrags, dtype=bool)
        luma[:g.planes[0].nfrags] = True
        per_plane = self._transform_quantize(coded & luma, frag_refi,
                                             residual)
        fragis, _, err2 = per_plane[0][:3]
        bits = _bits_est(per_plane[0])
        unc = self._uncoded_ssd_plane(planes, prev_rec, 0)[fragis]
        modes = frag_mode[fragis]
        lam_other = lam * self.skip_other_scale
        nomv = modes == MODE_INTER_NOMV
        skip = (unc <= err2 + (np.where(nomv, lam, lam_other) * bits)
                .astype(np.int64)) & (modes != MODE_INTER_MV_FOUR)
        if not self.skip_nonnomv:
            skip &= nomv
        self._luma_skip_guard_modes(fragis, skip, coded, frag_mode)
        if self.mb_rollback and len(fragis):
            mbis, lum, lc = self._mb_coded_luma(coded)
            safe = np.isin(mb_modes[mbis], _ROLLBACK_MODES)
            lum, lc = lum[safe], lc[safe]
            # Each MB's blocks as rows of the plane tuple; live: coded and
            # not skipped yet.
            idx = np.minimum(np.searchsorted(fragis, np.maximum(lum, 0)),
                             len(fragis) - 1)
            live = lc & ~skip[idx]
            lam_mb = np.where(mb_modes[mbis[safe]] == MODE_INTER_NOMV, lam,
                              lam_other)
            thr = (lam_mb * ((bits[idx] * live).sum(axis=1)
                             + self.mb_skip_overhead_bits)).astype(np.int64)
            roll = live.any(axis=1) & ((unc[idx] * live).sum(axis=1) <= (
                err2[idx] * live).sum(axis=1) + thr)
            skip[idx[live & roll[:, None]]] = True
        _apply_skip(per_plane, 0, skip, coded)
        # Mode forcing: an MB that lost all its coded luma transmits no
        # mode, so the decoder takes INTER_NOMV for its chroma.
        lum = g.mb_maps[:, 0]
        has_luma = (lum >= 0).any(axis=1)
        luma_coded = ((lum >= 0) & coded[np.maximum(lum, 0)]).any(axis=1)
        forced = np.flatnonzero(g.mb_valid & has_luma & ~luma_coded
                                & (mb_modes != MODE_INTER_NOMV))
        mb_modes[forced] = MODE_INTER_NOMV
        ch = g.mb_maps[forced, 1:].reshape(-1)
        ch = ch[ch >= 0]
        ch = ch[coded[ch]]
        frag_refi[ch] = FRAME_PREV
        frag_mode[ch] = MODE_INTER_NOMV
        frag_mv[ch] = 0
        per_chroma = self._transform_quantize(coded & ~luma, frag_refi,
                                              residual)
        for pli in (1, 2):
            per_plane[pli] = per_chroma[pli]
            fragis, _, err2 = per_plane[pli][:3]
            if len(fragis) == 0:
                continue
            unc = self._uncoded_ssd_plane(planes, prev_rec, pli)[
                fragis - g.planes[pli].froffset]
            skip = unc <= err2 + (lam * _bits_est(per_plane[pli])).astype(
                np.int64)
            if skip.any():
                _apply_skip(per_plane, pli, skip, coded)
        return per_plane

    def _mb_coded_luma(self, coded):
        """Per valid MB: its luma fragments [M, 4] (-1 where none), which
        of them are coded, and the MB indices."""
        g = self.geometry
        mbis = np.flatnonzero(g.mb_valid)
        lum = g.mb_maps[mbis, 0]
        return mbis, lum, (lum >= 0) & coded[np.maximum(lum, 0)]

    def _luma_all_skipped(self, fragis, skip, coded):
        """Per valid MB: its index, its first coded luma fragment, and
        whether it has coded luma that would all skip."""
        skipmap = np.zeros(self.geometry.nfrags, dtype=bool)
        skipmap[fragis] = skip
        mbis, lum, lc = self._mb_coded_luma(coded)
        first = lum[np.arange(len(lum)), lc.argmax(axis=1)]
        return mbis, first, lc.any(axis=1) & ~(
            lc & ~skipmap[np.maximum(lum, 0)]).any(axis=1)

    def _luma_skip_guard_modes(self, fragis, skip, coded, frag_mode):
        """Un-skip the first coded luma block of each MB whose mode moves
        the decoder's vector predictors (MV, LAST2, 4MV) and whose coded
        luma would all skip: its mode must stay transmitted
        (encoder.py:2389-2411)."""
        _, first, gone = self._luma_all_skipped(fragis, skip, coded)
        need = gone & np.isin(frag_mode[first], _GUARD_MODES)
        skip[np.searchsorted(fragis, first[need])] = False

    def _luma_skip_guard(self, fragis, skip, coded, frag_mode):
        """luma_ext_skip's guard: un-skip the first coded luma block of
        each non-NOMV MB whose coded luma would all skip while some of its
        chroma stays coded (encoder.py:2459-2484)."""
        mbis, first, gone = self._luma_all_skipped(fragis, skip, coded)
        ch = self.geometry.mb_maps[mbis, 1:].reshape(len(mbis), -1)
        chroma = ((ch >= 0) & coded[np.maximum(ch, 0)]).any(axis=1)
        need = gone & (frag_mode[first] != MODE_INTER_NOMV) & chroma
        skip[np.searchsorted(fragis, first[need])] = False

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

    def pack_frame_plan(self, ftype, coded, frag_refi, mb_modes, mb_mvs,
                        qdct_by_frag, qis=None, frag_qii=None) -> bytes:
        """Pack one frame from a coding plan made elsewhere (JAX's
        signature): FramePacker.pack_frame_plan at self.qi, a 4MV MB's
        block vectors from self._frag_mv4. coded: [nfrags] bool;
        frag_refi: [nfrags] FRAME_* (FRAME_NONE for uncoded);
        qdct_by_frag: [nfrags, 64] zig-zag values with the actual DC at 0;
        mb_modes, mb_mvs as packed; qis and frag_qii: adaptive
        quantization's qi list (more than one entry) and each block's
        index into it."""
        self._cur_fti = 0 if ftype == INTRA_FRAME else 1
        self._frame_qis = list(qis) if qis and len(qis) > 1 else None
        return self._fp.pack_frame_plan(
            ftype, self.qi, coded, frag_refi, mb_modes, mb_mvs,
            qdct_by_frag, frag_mv4=self._frag_mv4, qis=self._frame_qis,
            frag_qii=frag_qii)

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
