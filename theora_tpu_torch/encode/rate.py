"""Rate control: 1-pass CBR with frame dropping, the fixed-qi pass 1 and
the window allocation of pass 2 (the OT2P metrics file), after the
reference controller (rate.c).

Port of theora_tpu/encode/rate.py: `RateControl` (select_qi, update with
the post-encode frame drop, the rate flags drop_frames / cap_overflow /
cap_underflow, resize_buffer, set_bitrate, start_pass1,
pass1_frame_data, pass1_summary, pack_metrics, twopass_parse,
start_pass2 and its window machinery), `FrameMetrics`, `BesselFollower`
and `twopass_window_qvecs`. Only the host Encoder (encode/encoder.py)
passes droppable=True; the device encoders never drop a frame. Left out,
as no caller of the port sets them: the JAX update's trial encodes, dup
counts and activity average. The constructor takes no dequant tables
(the JAX one's argument is unused).
The arithmetic is the JAX package's, float by float, so the qi choices,
the drops and the pass-1 file are byte-identical; numeric constants
lifted from the reference are cited. The CBR path of
`GopEncoder.encode_clip` uses `WindowRateController` (encode/gop.py)
instead.
"""
from __future__ import annotations

import copy
import dataclasses
import math
import struct

from theora_tpu_torch.encode.qavg_tables import LOG_QAVG

INTRA = 0
INTER = 1

# log2 of the reference's keyframe/delta rate ratio (rate.c:638
# LOG_KEY_RATIO=0x0137222BB70747BA in Q57): keyframes are budgeted
# ~1.524x the bits-per-quantizer-step of delta frames.
LOG_KEY_RATIO = 0x0137222BB70747BA / (1 << 57)
# Per-frame quality-change clamp: +/- log2 step (rate.c:689, Q57
# 0x00A4D3C25E68DC58 = log2(1.25)).
LOG_QI_CLAMP = 0x00A4D3C25E68DC58 / (1 << 57)
# log2(OC_QUANT_MAX=4096) (enquant.h:7, quant.h:27).
QUANT_MAX_LOG = 12.0

TWOPASS_MAGIC = 0x5032544F  # "OT2P"
TWOPASS_VERSION = 2         # OC_RC_2PASS_VERSION, rate.c:866
TWOPASS_HDR_SZ = 38         # OC_RC_2PASS_HDR_SZ
TWOPASS_PACKET_SZ = 12      # OC_RC_2PASS_PACKET_SZ


@dataclasses.dataclass
class FrameMetrics:
    """One pass-1 frame record (oc_frame_metrics, encint.h:518-528)."""
    frame_type: int
    log_scale: float          # log2 of the measured rate-model scale
    dup_count: int = 0
    activity_avg: int = 0


class BesselFollower:
    """2nd-order low-pass Bessel filter with a delay-dependent time
    constant -- float re-derivation of oc_iir_filter_* (rate.c:54-128;
    coefficient recipe per the 2-pole filter construction cited there):
    warp = tan(pi/2 * 1/delay), k1 = 3*warp, k2 = k1*warp,
    a = k2/(1+k1+k2), b1 = 2*a*(1/k2-1), b2 = 1-4*a-b1; DC gain is 1.
    """

    __slots__ = ("g", "c0", "c1", "x0", "x1", "y0", "y1")

    def __init__(self, delay: int, value: float):
        self.reinit(delay)
        self.x0 = self.x1 = self.y0 = self.y1 = value

    def reinit(self, delay: int) -> None:
        """Change the reaction time without altering filter state
        (oc_iir_filter_reinit)."""
        alpha = 1.0 / max(delay, 1)
        warp = max(math.tan(alpha * math.pi / 2.0), 1e-9)
        k1 = 3.0 * warp
        k2 = k1 * warp
        d = 1.0 + k1 + k2
        a = k2 / d
        self.g = a
        self.c0 = 2.0 * a * (1.0 / k2 - 1.0)
        self.c1 = 1.0 - 4.0 * a - self.c0

    def update(self, x: float) -> float:
        ya = (x + 2.0 * self.x0 + self.x1) * self.g \
            + self.y0 * self.c0 + self.y1 * self.c1
        self.x1 = self.x0
        self.x0 = x
        self.y1 = self.y0
        self.y0 = ya
        return ya


class RateControl:
    def __init__(self, info, keyframe_freq: int,
                 buf_delay: int | None = None):
        self.info = info
        self.keyframe_freq = max(int(keyframe_freq), 1)
        fps = info.fps_numerator / info.fps_denominator
        self.npixels = info.frame_width * info.frame_height
        self.log_npixels = math.log2(self.npixels)
        # Quantizer floor: in CBR mode th_info.quality is the minimum
        # allowed quality (oc_enc_find_qi_for_target gets
        # state.info.quality as _qi_min; theoraenc.h docs).
        self.qi_min = max(0, min(63, int(getattr(info, "quality", 0))))
        fmt = getattr(info, "pixel_fmt", 0)
        self.log_qavg = LOG_QAVG.get(fmt, LOG_QAVG[0])  # [qti][qi]
        # Buffer: keyframe interval clamped to [12,256] frames unless
        # the caller overrides (oc_rc_state_init, rate.c:320-345).
        self.buf_delay = (
            max(12, min(buf_delay, 256 * 256)) if buf_delay
            else min(max(self.keyframe_freq, 12), 256)
        )
        self.drop_frames = True
        self.cap_overflow = True
        self.cap_underflow = False
        self.twopass = 0
        self.twopass_force_kf = False
        self.frame_metrics: list[FrameMetrics] = []  # pass-1 output log
        self._finite_window = False
        self.ndrops = 0           # cumulative drop count (diagnostics)
        self._reset(fps)

    # ------------------------------------------------------------------
    def _reset(self, fps: float | None = None) -> None:
        """(Re)initialize the reservoir and model (oc_enc_rc_reset)."""
        if fps is None:
            fps = self.info.fps_numerator / self.info.fps_denominator
        self.bits_per_frame = min(
            max(self.info.target_bitrate / fps, 32.0), float(1 << 46)
        )
        self.buf_delay = max(self.buf_delay, 12)
        self.max_fullness = self.bits_per_frame * self.buf_delay
        # Fullness target: 50% plus a quarter of a keyframe interval's
        # bits, reserving keyframe headroom (rate.c:263-269).
        self.target = self.max_fullness / 2.0 + (self.bits_per_frame / 4.0) \
            * min(self.keyframe_freq, self.buf_delay)
        self.fullness = self.target
        # Initial model exponents/scales by inverse bits-per-pixel
        # bucket (rate.c:275-300; exps are Q6, scales are /256; integer
        # division as in the reference so bucket edges match).
        ibpp = self.npixels // int(self.bits_per_frame)
        if ibpp < 1:
            exp0, scale0 = 59, 1997.0
        elif ibpp < 2:
            exp0, scale0 = 55, 1604.0
        else:
            exp0, scale0 = 48, 834.0
        if ibpp < 4:
            exp1, scale1 = 100, 2249.0
        elif ibpp < 8:
            exp1, scale1 = 95, 1751.0
        else:
            exp1, scale1 = 73, 1260.0
        self.exp = [exp0 / 64.0, exp1 / 64.0]
        self.log_scale = [math.log2(scale0 / 256.0), math.log2(scale1 / 256.0)]
        self.prev_drop_count = 0
        self.log_drop_scale = 0.0
        self.scalefilter = [
            BesselFollower(4, self.log_scale[0]),
            None,
        ]
        inter_delay = (
            max(self.keyframe_freq, 12) if self.twopass else self.buf_delay
        ) >> 1
        self.inter_count = 0
        # Start reactive, lengthen toward the target as stats accumulate
        # (rate.c:352-360).
        self.inter_delay = 10
        self.inter_delay_target = inter_delay
        self.scalefilter[1] = BesselFollower(self.inter_delay,
                                             self.log_scale[1])
        self.vfrfilter = BesselFollower(4, 2.0 ** self.log_drop_scale)
        self.rate_bias = 0.0
        self.nencoded = 0
        self._frames_since_kf = 0
        self.log_qtarget = self.log_qavg[0][max(self.qi_min, 40)]
        # Pass-2 model correction: pass-1 scales were measured at the
        # pass-1 qi, and the rate = scale * q^-exp model carries a
        # systematic offset at a different operating qi.  One-pass mode
        # self-corrects because its scale follower tracks *realized*
        # scales; two-pass would otherwise keep the offset for the whole
        # clip (the reference does, under-spending up to ~15%).  We
        # learn the log-domain offset online per frame type from
        # realized-vs-pass-1 scale and add it to the window estimates.
        self._tp_bias = [0.0, 0.0]
        self._tp_bias_n = [0, 0]
        self._tp_raw_cur_scale = None

    def _tp_bias_for(self, qti: int) -> float:
        """Learned pass-2 model offset for a frame type, borrowing the
        other type's estimate before any sample of our own exists."""
        if self._tp_bias_n[qti] > 0:
            return self._tp_bias[qti]
        if self._tp_bias_n[1 - qti] > 0:
            return self._tp_bias[1 - qti]
        return 0.0

    # ------------------------------------------------------------------
    def _scale_drop(self, nframes: int) -> int:
        """Scale a frame count down by the expected drop/dup rate
        (oc_rc_scale_drop, rate.c:448-461)."""
        if self.prev_drop_count > 0 or self.log_drop_scale > 0.0:
            dup_scale = 2.0 ** (
                (self.log_drop_scale + math.log2(self.prev_drop_count + 1))
                / 2.0
            )
            if dup_scale < nframes:
                if dup_scale > 1.0:
                    nframes = int(math.ceil(nframes / dup_scale))
            else:
                nframes = 1 if nframes else 0
        return nframes

    # ------------------------------------------------------------------
    def resize_buffer(self, buf_delay: int, started: bool = True) -> None:
        """On-the-fly rate buffer resize (oc_enc_rc_resize, rate.c:345):
        update the bounds but not the current fullness once encoding has
        begun."""
        self.buf_delay = max(12, min(int(buf_delay), 256 * 256))
        if not started or self.nencoded == 0:
            self._reset()
            return
        fps = self.info.fps_numerator / self.info.fps_denominator
        self.bits_per_frame = min(
            max(self.info.target_bitrate / fps, 32.0), float(1 << 46)
        )
        self.max_fullness = self.bits_per_frame * self.buf_delay
        self.target = self.max_fullness / 2.0 + (self.bits_per_frame / 4.0) \
            * min(self.keyframe_freq, self.buf_delay)
        idt = max(self.buf_delay >> 1, 10)
        self.inter_delay_target = idt
        # Jump to the new delay immediately if enough frames were seen;
        # otherwise it is just the new target (rate.c:372-379).
        if idt < min(self.inter_delay, self.inter_count):
            self.scalefilter[1].reinit(idt)
            self.inter_delay = idt
        if self.twopass == 2:
            self._finite_window = True
            self._tp_refill_window()

    def set_bitrate(self, bitrate: int) -> None:
        """Mid-stream bitrate change (TH_ENCCTL_SET_BITRATE: a resize
        that keeps the fullness, encode.c:1359-1553)."""
        self.info.target_bitrate = bitrate
        self.resize_buffer(self.buf_delay)

    def set_rate_flags(self, flags: int) -> None:
        """TH_RATECTL_DROP_FRAMES | CAP_OVERFLOW | CAP_UNDERFLOW
        (theoraenc.h:390-405)."""
        self.drop_frames = bool(flags & 1)
        self.cap_overflow = bool(flags & 2)
        self.cap_underflow = bool(flags & 4)

    # ------------------------------------------------------------------
    def select_qi(self, frame_type: int, prev_qi: int | None,
                  frames_since_kf: int | None = None,
                  clamp: bool = True) -> int:
        """Choose qi for the next frame (oc_enc_select_qi,
        rate.c:463-730)."""
        qti = INTRA if frame_type == INTRA else INTER
        log_cur_scale = self.scalefilter[qti].y0
        buf_pad = 0
        if self.twopass == 1:
            # Pass 1: fixed qi (rate.c:502-506) chosen at pass start.
            qi = self._pass1_qi
            self.log_qtarget = self.log_qavg[qti][qi]
            return qi
        if self.twopass == 2:
            nframes, buf_delay, buf_pad, log_scale1_override = \
                self._tp_window_estimates(qti, log_cur_scale)
            log_cur_scale = self._tp_log_cur_scale
        else:
            # 1-pass: count the forced keyframes inside the buffer
            # window and target the last keyframe boundary before the
            # window's end (rate.c:482-499).
            fsk = (frames_since_kf if frames_since_kf is not None
                   else self._frames_since_kf)
            next_key = (
                max(self.keyframe_freq - fsk, 0) if qti == INTER else 0
            )
            nframes0 = (
                self.buf_delay - min(next_key, self.buf_delay)
                + self.keyframe_freq - 1
            ) // self.keyframe_freq
            if nframes0 + qti > 1:
                nframes0 -= 1
                buf_delay = next_key + nframes0 * self.keyframe_freq
            else:
                buf_delay = self.buf_delay
            nframes = [nframes0, buf_delay - nframes0]
            # Downgrade the delta-frame count by the recent drop history.
            nframes[1] = self._scale_drop(nframes[1])
            log_scale1_override = None
        # Persistent-miss penalty (rate.c:626-628).
        rate_bias = (self.rate_bias / (self.nencoded + 1000)) \
            * (buf_delay - buf_pad)
        rate_total = self.fullness - self.target + rate_bias \
            + buf_delay * self.bits_per_frame
        log_scale0 = self.log_scale[qti] + self.log_npixels
        if rate_total <= buf_delay or nframes[qti] <= 0:
            # Not enough bits to reach the target fullness: minimum
            # quality (rate.c:634-635).
            log_qtarget = QUANT_MAX_LOG
        else:
            log_scale1 = (
                log_scale1_override
                if log_scale1_override is not None
                else self.log_scale[1 - qti]
            ) + self.log_npixels
            n_this, n_other = nframes[qti], nframes[1 - qti]
            sign = 1.0 if qti == INTER else -1.0

            def excess(r_bits: float) -> float:
                # Bits consumed by the window if this frame type gets
                # r_bits per frame, the other type scaling by the model
                # with the keyframe ratio applied (rate.c:640-660).
                log_rpow = (math.log2(r_bits) - log_scale0) / self.exp[qti]
                log_rpow = (log_rpow + sign * LOG_KEY_RATIO) \
                    * self.exp[1 - qti]
                rscale = n_other * 2.0 ** (log_scale1 + log_rpow)
                return n_this * r_bits + rscale - rate_total

            rlo, rhi = 1.0, rate_total / n_this
            for _ in range(64):
                mid = (rlo + rhi) / 2.0
                if excess(mid) < 0.0:
                    rlo = mid
                else:
                    rhi = mid
            log_qtarget = 2.0 - (math.log2(rlo) - log_scale0) / self.exp[qti]
            log_qtarget = min(log_qtarget, QUANT_MAX_LOG)
        exp0 = self.exp[qti]
        # Soft overflow cap: keep 3% margin bits from going to waste
        # (rate.c:663-683).
        if self.cap_overflow:
            margin = self.max_fullness / 32.0
            soft_limit = self.fullness + self.bits_per_frame \
                - (self.max_fullness - margin)
            if soft_limit >= 1.0:
                log_soft_limit = math.log2(soft_limit)
                log_qexp = (log_qtarget - 2.0) * exp0
                if log_scale0 - log_qexp < log_soft_limit:
                    log_qexp += (log_scale0 - log_soft_limit - log_qexp) \
                        * (min(margin, soft_limit) / margin)
                    log_qtarget = log_qexp / exp0 + 2.0
        # Limit the quality change per frame (rate.c:685-694).
        old_qi = prev_qi if prev_qi is not None else max(self.qi_min, 40)
        if clamp and self.nencoded > 0:
            log_qtarget = max(
                min(log_qtarget, self.log_qavg[qti][old_qi] + LOG_QI_CLAMP),
                self.log_qavg[qti][old_qi] - LOG_QI_CLAMP,
            )
        # Hard underflow limit on the very next frame, only without a
        # quality floor (rate.c:695-716 -- saturating with a floor
        # interacts badly with SKIP).
        if self.qi_min == 0:
            hard = self.fullness + self.bits_per_frame / 2.0
            if hard >= 1.0:
                log_hard_limit = math.log2(hard)
                log_qexp = (log_qtarget - 2.0) * exp0
                if log_scale0 - log_qexp > log_hard_limit:
                    log_qtarget = min(
                        (log_scale0 - log_hard_limit) / exp0 + 2.0,
                        QUANT_MAX_LOG,
                    )
        # Update the bias with the bits we plan to use (rate.c:718-720).
        self.rate_bias += 2.0 ** (
            log_cur_scale + self.log_npixels - (log_qtarget - 2.0) * exp0
        )
        qi = self._find_qi_for_target(qti, old_qi, self.qi_min, log_qtarget)
        self.log_qtarget = log_qtarget
        return qi

    def _find_qi_for_target(
        self, qti: int, qi_old: int, qi_min: int, log_qtarget: float
    ) -> int:
        """Nearest-quantizer search, ties toward the old qi
        (oc_enc_find_qi_for_target, rate.c:131-149)."""
        best_qi = qi_min
        best = abs(self.log_qavg[qti][best_qi] - log_qtarget)
        for qi in range(qi_min + 1, 64):
            d = abs(self.log_qavg[qti][qi] - log_qtarget)
            if d < best or (d == best and abs(qi - qi_old)
                            < abs(best_qi - qi_old)):
                best, best_qi = d, qi
        return best_qi

    # ------------------------------------------------------------------
    def update(self, frame_type: int, qi: int, bits: int,
               droppable: bool = False) -> bool:
        """Post-frame state update; returns True if the frame must be
        dropped (oc_enc_update_rc_state, rate.c:731-870). Only a
        droppable frame drops; the caller replaces it with a 0-byte dup
        packet and must not advance the reference frames with the coded
        data."""
        qti = INTRA if frame_type == INTRA else INTER
        if not self.drop_frames or (
            self.twopass == 2 and not self._finite_window
        ):
            droppable = False
        if bits <= 0:
            log_scale = -64.0
            bits = 0
        else:
            log_scale = min(
                math.log2(bits) - self.log_npixels
                + (self.log_qtarget - 2.0) * self.exp[qti],
                16.0,
            )
        if self.twopass == 1:
            self._cur_metrics = FrameMetrics(qti, log_scale)
            self.frame_metrics.append(self._cur_metrics)
        elif self.twopass == 2:
            if bits > 0 and self._tp_raw_cur_scale is not None:
                # Model-offset sample: realized scale vs the pass-1
                # scale the prediction was based on (see _reset).
                sample = log_scale - self._tp_raw_cur_scale
                n = min(self._tp_bias_n[qti], 15)
                self._tp_bias[qti] = (self._tp_bias[qti] * n + sample) \
                    / (n + 1)
                self._tp_bias_n[qti] += 1
            self._tp_advance_window()
        dropped = False
        if bits > 0:
            if (
                self.inter_delay < self.inter_delay_target
                and self.inter_count >= self.inter_delay
                and qti == INTER
            ):
                self.inter_delay += 1
                self.scalefilter[1].reinit(self.inter_delay)
            self.log_scale[qti] = self.scalefilter[qti].update(log_scale)
            if droppable and self.fullness + self.bits_per_frame < bits:
                self.prev_drop_count += 1
                bits = 0
                dropped = True
                self.ndrops += 1
            else:
                drop_count = min(self.prev_drop_count + 1, 0x7F)
                self.log_drop_scale = math.log2(
                    max(self.vfrfilter.update(float(drop_count)), 1e-9)
                )
                self.prev_drop_count = 0
            if qti == INTER:
                self.inter_count += 1
        else:
            self.prev_drop_count += 1
        self.fullness += self.bits_per_frame - bits
        if self.cap_overflow:
            self.fullness = min(self.fullness, self.max_fullness)
        if self.cap_underflow:
            self.fullness = max(self.fullness, 0.0)
        self.rate_bias -= bits
        self.nencoded += 1
        if qti == INTRA:
            self._frames_since_kf = 0
        else:
            self._frames_since_kf += 1
        return dropped

    # ------------------------------------------------------------------
    # 2-pass: pass 1 side.
    # ------------------------------------------------------------------
    def start_pass1(self) -> bytes:
        """Enter pass-1 mode: pick the fixed measurement qi and return
        the 38-byte placeholder header to write at the start of the
        metrics file (oc_enc_rc_2pass_out first call, rate.c:878-897)."""
        self._pass1_qi = self.select_qi(INTRA, None, clamp=False)
        self.twopass = 1
        self.frame_metrics = []
        return struct.pack("<II", TWOPASS_MAGIC, TWOPASS_VERSION) \
            + b"\0" * (TWOPASS_HDR_SZ - 8)

    @staticmethod
    def pack_metrics(m: FrameMetrics) -> bytes:
        """One 12-byte little-endian pass-1 record: dup|type<<31,
        log_scale in Q24 (log2 domain), activity_avg (rate.c:901-905).
        Bit 31 is SET for inter frames (OC_INTRA_FRAME=0<<31 clears it,
        state.h frame-type constants)."""
        word0 = (m.dup_count & 0x7FFFFFFF) | (
            0x80000000 if m.frame_type == INTER else 0
        )
        q24 = int(round(m.log_scale * (1 << 24)))
        q24 = max(-(1 << 31), min(q24, (1 << 31) - 1))
        return struct.pack(
            "<IiI", word0, q24, m.activity_avg & 0xFFFFFFFF
        )

    def pass1_frame_data(self) -> bytes:
        """The record for the frame just encoded (pass 1)."""
        return self.pack_metrics(self._cur_metrics)

    def pass1_summary(self) -> bytes:
        """The final 38-byte summary header, to be rewritten at file
        offset 0 after the last frame (rate.c:908-919): magic, version,
        frames_total[intra, inter, dup], exp[2] (Q6 bytes),
        scale_sum[2] (Q24, 8 bytes each)."""
        nframes = [0, 0, 0]
        scale_sum = [0, 0]
        for m in self.frame_metrics:
            nframes[m.frame_type] += 1
            nframes[2] += m.dup_count
            scale_sum[m.frame_type] += self._bexp_q24(m.log_scale)
        return struct.pack(
            "<IIIIIBBqq",
            TWOPASS_MAGIC, TWOPASS_VERSION,
            nframes[0], nframes[1], nframes[2],
            int(round(self.exp[0] * 64)), int(round(self.exp[1] * 64)),
            scale_sum[0], scale_sum[1],
        )

    @staticmethod
    def _bexp_q24(log_scale: float) -> int:
        """Q24 binary exponential with the reference's saturation
        (oc_bexp_q24, rate.c:209-216)."""
        if log_scale >= 23.0:
            return 0x7FFFFFFFFFFF
        return min(int(round(2.0 ** (log_scale + 24.0))), 0x7FFFFFFFFFFF)

    # ------------------------------------------------------------------
    # 2-pass: pass 2 side.
    # ------------------------------------------------------------------
    @classmethod
    def twopass_parse(cls, data: bytes):
        """Parse a complete pass-1 metrics file (reference layout) ->
        (summary dict, [FrameMetrics])."""
        if len(data) < TWOPASS_HDR_SZ:
            raise ValueError("2-pass file too short")
        magic, version, n0, n1, n2, e0, e1, s0, s1 = struct.unpack_from(
            "<IIIIIBBqq", data, 0
        )
        if magic != TWOPASS_MAGIC:
            raise ValueError("bad 2-pass magic")
        if version != TWOPASS_VERSION:
            raise ValueError(f"unsupported 2-pass version {version}")
        if n0 == 0:
            raise ValueError("2-pass file has no keyframes (aborted pass 1?)")
        summary = {
            "frames_total": [n0, n1, n2],
            "exp": [e0 / 64.0, e1 / 64.0],
            "scale_sum": [s0, s1],
        }
        metrics = []
        off = TWOPASS_HDR_SZ
        while off + TWOPASS_PACKET_SZ <= len(data):
            word0, q24, act = struct.unpack_from("<IiI", data, off)
            off += TWOPASS_PACKET_SZ
            metrics.append(
                FrameMetrics(
                    INTER if word0 & 0x80000000 else INTRA,
                    q24 / (1 << 24),
                    word0 & 0x7FFFFFFF,
                    act,
                )
            )
        if len(metrics) < n0 + n1:
            raise ValueError(
                f"2-pass file truncated: {len(metrics)} records, "
                f"summary claims {n0 + n1}"
            )
        return summary, metrics

    def start_pass2(self, data: bytes, buf_delay: int | None = None) -> None:
        """Enter pass-2 mode from a complete pass-1 metrics file.
        With buf_delay=None the whole file is the allocation window
        (frame_metrics==NULL mode, rate.c:1010-1023); otherwise a finite
        sliding window of known future frame types is maintained
        (rate.c:1060-1126)."""
        summary, metrics = self.twopass_parse(data)
        self.twopass = 2
        self._tp_records = metrics
        self._tp_next = 0          # next unconsumed record index
        self._tp_pos = 0           # index of the frame about to encode
        self.exp = list(summary["exp"])
        nf = summary["frames_total"]
        self.frames_total = list(nf)
        if buf_delay is None:
            # Whole-file window.
            self._finite_window = False
            self.buf_delay = max(nf[0] + nf[1] + nf[2], 12)
            self._reset()
            self.exp = list(summary["exp"])
            self._win_nframes = [nf[0], nf[1], nf[2]]
            self._win_scale_sum = [
                summary["scale_sum"][0] / float(1 << 24),
                summary["scale_sum"][1] / float(1 << 24),
            ]
            self._win_start = 0
            self._win_end = nf[0] + nf[1] + nf[2]
            self._tp_next = len(metrics)
        else:
            self._finite_window = True
            self.buf_delay = max(12, min(buf_delay, 256))
            self._reset()
            self.exp = list(summary["exp"])
            self._win_nframes = [0, 0, 0]
            self._win_scale_sum = [0.0, 0.0]
            self._win_start = 0
            self._win_end = 0
            self._win_head = 0     # index into _tp_records of window head
            self._tp_refill_window()
        self._tp_set_cur()

    def _tp_refill_window(self) -> None:
        """Extend the finite window with known future records until it
        covers buf_delay frames (rate.c:1060-1114)."""
        while (
            self._win_end - self._win_start < self.buf_delay
            and self._tp_next < len(self._tp_records)
        ):
            m = self._tp_records[self._tp_next]
            self._tp_next += 1
            self._win_nframes[m.frame_type] += 1
            self._win_nframes[2] += m.dup_count
            self._win_scale_sum[m.frame_type] += 2.0 ** m.log_scale
            self._win_end += m.dup_count + 1

    def _tp_set_cur(self) -> None:
        if self._tp_pos < len(self._tp_records):
            self._cur_metrics = self._tp_records[self._tp_pos]
            self.twopass_force_kf = self._cur_metrics.frame_type == INTRA
        else:
            self.twopass_force_kf = False

    def _tp_advance_window(self) -> None:
        """Back the just-coded frame out of the sliding window and pull
        the next known record in (rate.c:768-797)."""
        if self._tp_pos >= len(self._tp_records):
            # More frames than pass 1 recorded: nothing left to slide.
            return
        m = self._tp_records[self._tp_pos]
        self._win_nframes[m.frame_type] -= 1
        self._win_nframes[2] -= m.dup_count
        self._win_scale_sum[m.frame_type] -= 2.0 ** m.log_scale
        self._win_start += m.dup_count + 1
        self._tp_pos += 1
        if self._finite_window:
            self._tp_refill_window()
        self._tp_set_cur()

    def _tp_window_estimates(self, qti: int, log_cur_scale: float):
        """Pass-2 window statistics for select_qi (rate.c:508-625):
        exact future frame-type counts, keyframe-boundary targeting, and
        end-of-file padding. Returns (nframes[2], buf_delay, buf_pad,
        log_scale1_override) and sets self.log_scale from the window."""
        if self._tp_pos >= len(self._tp_records):
            # Encoding past the last pass-1 record: degenerate 1-frame
            # window using the follower's current estimate.
            self._tp_log_cur_scale = log_cur_scale
            self._tp_raw_cur_scale = None
            nf = [0, 0]
            nf[qti] = 1
            return nf, 1, 0, None
        nframes = [self._win_nframes[0], self._win_nframes[1]]
        scale_sum = [self._win_scale_sum[0], self._win_scale_sum[1]]
        buf_delay = min(self._win_end - self._win_start, self.buf_delay)
        # End-of-file slack: position the target where the first forced
        # keyframe beyond the end of the file would be (rate.c:524-531).
        kf_num = max(self._tp_pos - self._frames_since_kf - 1, 0)
        buf_pad = min(
            self.buf_delay,
            kf_num + self.keyframe_freq - self._win_start,
        )
        if buf_delay < buf_pad:
            buf_pad -= buf_delay
        else:
            buf_pad = 0
            # Search for the last keyframe in the window and target it
            # (rate.c:532-566), finite-window mode only.
            if self._finite_window:
                end = self._tp_pos + (self._win_end - self._win_start)
                end = min(end, len(self._tp_records))
                for i in range(end - 1, self._tp_pos, -1):
                    m = self._tp_records[i]
                    if m.frame_type == INTRA:
                        for j in range(i, end):
                            mj = self._tp_records[j]
                            nframes[mj.frame_type] -= 1
                            scale_sum[mj.frame_type] -= 2.0 ** mj.log_scale
                            buf_delay -= mj.dup_count + 1
                        break
        # If the current frame type differs from pass 1 (changed
        # keyframe interval), swap the estimate (rate.c:567-599).
        cur = self._cur_metrics
        if cur.frame_type != qti:
            nframes[cur.frame_type] -= 1
            scale_sum[cur.frame_type] -= 2.0 ** cur.log_scale
        for t in (0, 1):
            self.log_scale[t] = (
                math.log2(scale_sum[t] / nframes[t])
                if nframes[t] > 0 and scale_sum[t] > 0
                else -self.log_npixels
            )
        if cur.frame_type != qti:
            scale = 2.0 ** self.log_scale[qti] * nframes[qti] \
                + 2.0 ** log_cur_scale
            nframes[qti] += 1
            self.log_scale[qti] = math.log2(max(scale / nframes[qti], 1e-12))
        else:
            log_cur_scale = cur.log_scale
        # Extend the window past EOF with the filtered scale
        # (rate.c:600-616).
        if buf_pad > 0:
            buf_delay += buf_pad
            nextra = self._scale_drop(buf_pad)
            scale = 2.0 ** self.log_scale[1] * nframes[1] \
                + 2.0 ** self.scalefilter[1].y0 * nextra
            nframes[1] += nextra
            self.log_scale[1] = math.log2(max(scale / nframes[1], 1e-12))
        # Apply the learned model offset (see _reset); keep the raw
        # pass-1 scale of the current frame so update() can measure the
        # next offset sample against it.
        for t in (0, 1):
            self.log_scale[t] += self._tp_bias_for(t)
        if cur.frame_type == qti:
            self._tp_raw_cur_scale = log_cur_scale
            log_cur_scale += self._tp_bias_for(qti)
        else:
            self._tp_raw_cur_scale = None
        self._tp_log_cur_scale = log_cur_scale
        return nframes, buf_delay, buf_pad, None


# ---------------------------------------------------------------------
def twopass_window_qvecs(rc: "RateControl", gop_lens, prev_qi: int):
    """Per-frame qi vectors for a window of GOPs in pass 2, for an
    encoder that must fix each frame's quantizer before it encodes the
    GOP (GopEncoder.encode_clip_pass2).

    Virtually runs the reference's select_qi/update interleaving
    (rate.c:463-870) across the window's frames with MODEL-estimated
    bits (2^(scale + npixels - q*exp), the same model the allocator
    budgets with), from the window-start controller state.  The state
    is snapshotted and restored, so only REAL bits ever enter the
    persistent controller -- and because the pre-pass sees no real
    bits, the vectors are a pure function of (pass-1 metrics,
    window-start state).

    gop_lens: frame count per GOP (frame 0 of each GOP is the
    keyframe).  Returns one qi list per GOP.
    """
    snap = copy.deepcopy(rc.__dict__)
    qvecs = []
    prev = prev_qi
    try:
        for n in gop_lens:
            qv = []
            for j in range(n):
                ft = 0 if j == 0 else 1
                q = rc.select_qi(ft, prev)
                prev = q
                qv.append(q)
                est = 2.0 ** (
                    rc._tp_log_cur_scale + rc.log_npixels
                    - (rc.log_qtarget - 2.0) * rc.exp[ft]
                )
                rc.update(ft, q, int(est))
            qvecs.append(qv)
    finally:
        rc.__dict__.clear()
        rc.__dict__.update(snap)
    return qvecs
