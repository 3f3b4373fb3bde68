"""Device GOP encoder: motion estimation, the closed-loop plane encode and
the reconstruction on the card; mode decision and entropy coding on the
host.

Port of theora_tpu/encode/tpu_gop.py (`TpuGopEncoder`: the constructor,
`set_qi`, `set_splevel`, `_lam_t_for`, `_adaptive_qis`, `_decide_frames`,
`_frag_plan`, `_plane_inputs`, `dispatch_me`, `complete_dispatch`,
`finish_gop`, `dispatch_gop`, `_pack_gop`, `encode_gop`, `encode_clip`,
`encode_clip_pass1`, `encode_clip_pass2`, `encode_clip_twopass`;
`transcode_device`, `WindowRateController`, `detect_scene_cuts` and
`gop_starts`) with every setting of the JAX encoder: speed levels 0-4
(the trellis at 0-1, the R/D quantizer at 2-4 or with use_trellis=False,
no motion compensation at 4), any rd_strength, adaptive quantization
(False, True or the default "auto"), scene-cut keyframes, CBR
(target_bitrate, rate_window) and 2-pass rate control. Its packets, and
its 2-pass metrics, are byte-identical to the JAX encoder's.

A chunk of frames (consecutive GOPs, `clip_batch` frames at most) goes
through three stages, none of which waits for work queued after its own:
  1. dispatch_me: upload the planes from pinned memory (or take planes
     already on the card); the ME plan on the device (kernel KM,
     ops/me_cuda.py; ops/me.py on the CPU); start the plan's copy to the
     host;
  2. complete_dispatch: wait for that copy; the host's sequential mode
     decision (native `mode_decide_native`) and per-fragment plan; per
     frame the adaptive-quantization gates and qi list (encode/aq.py),
     padded to the chunk's longest list by repeating the base qi; per
     plane the closed-loop encode (encode/scan.py: kernels K2, KT or KR,
     and K1 once per frame at every qi row) on the device; start the
     copies of the coded flags and qi indices;
  3. finish_gop: wait for those; find and bring down the nonzero
     coefficients on a side stream; pack on the host
     (encode/packer.py).
encode_clip runs the chunks two deep, as JAX does: chunk k+1's upload and
ME are queued before chunk k's plane encodes, which are queued before
chunk k-1's packing. GOPs are independent, so the overlap cannot change a
byte. With a target bitrate each GOP is a chunk of its own and the chunks
run in turn, since the qi moves between GOPs (WindowRateController); in a
2-pass encode each frame has its own qi (`frame_qi`). transcode_device
feeds the batch decoder's planes to the same stages on the card, and the
mesh encoder (parallel/gop.py) a chunk of G equal-length GOPs, which the
plane scans run side by side on their GOP axis; over the ranks of a frag
group each rank encodes its share of every frame's fragments, and the
group's first rank packs.
"""
from __future__ import annotations

import copy
import time
from collections import deque

import numpy as np
import torch
from torch.profiler import record_function

from theora_tpu_torch import resolve_device, transfer
from theora_tpu_torch.constants import (
    DCT_TOKEN_EXTRA_BITS,
    FRAME_GOLD,
    FRAME_NONE,
    FRAME_PREV,
    FRAME_SELF,
    MODE_GOLDEN_MV,
    MODE_GOLDEN_NOMV,
    MODE_INTER_MV,
    MODE_INTER_MV_FOUR,
    MODE_INTER_MV_LAST,
    MODE_INTER_MV_LAST2,
    MODE_INTER_NOMV,
    MODE_INTRA,
    MVMAP,
    MVMAP2,
    ZZI_GROUP,
)
from theora_tpu_torch.decode.batch import BatchDecoder
from theora_tpu_torch.encode import aq
from theora_tpu_torch.encode.packer import FramePacker
from theora_tpu_torch.encode.rate import RateControl, twopass_window_qvecs
from theora_tpu_torch.encode.scan import encode_plane
from theora_tpu_torch.info import INTER_FRAME, INTRA_FRAME, TheoraInfo
from theora_tpu_torch.native import mode_decide_native
from theora_tpu_torch.ops import me_cuda
from theora_tpu_torch.ops.transforms import rd_lambda
from theora_tpu_torch.tables import RD_LAMBDA
from theora_tpu_torch.tpkt import Packet

_RS_OF = np.zeros(8, np.int8)
for _m in (MODE_INTER_NOMV, MODE_INTER_MV, MODE_INTER_MV_LAST,
           MODE_INTER_MV_LAST2, MODE_INTER_MV_FOUR):
    _RS_OF[_m] = 1
_RS_OF[MODE_GOLDEN_NOMV] = _RS_OF[MODE_GOLDEN_MV] = 2
_RS_OF[MODE_INTRA] = 0
_MV_MODES = np.zeros(8, bool)
_MV_MODES[[MODE_INTER_MV, MODE_INTER_MV_LAST, MODE_INTER_MV_LAST2,
           MODE_GOLDEN_MV]] = True
_RS_TO_REF = np.array([FRAME_SELF, FRAME_PREV, FRAME_GOLD], np.int32)


# The ME plan goes to the host narrowed, exactly: its vectors (half-pel,
# within +-31) as int8, its SADs (at most 256 * 255 = 65280) as int16
# offset by -32768. Indices of the vectors among plan()'s outputs.
_PLAN_VECTORS = (0, 5, 7, 9)


def _narrow_plan(outs) -> list:
    return [o.to(torch.int8) if i in _PLAN_VECTORS
            else (o - 32768).to(torch.int16) for i, o in enumerate(outs)]


def _widen_plan(host) -> list[np.ndarray]:
    return [h.astype(np.int32) if i in _PLAN_VECTORS
            else h.astype(np.int32) + 32768 for i, h in enumerate(host)]


def _nonzeros(qout: torch.Tensor, row0: int, nrows: int):
    """The nonzero entries of qout, [F, n, 64] int16 blocks that are rows
    row0 .. row0 + n - 1 of each frame's [nrows, 64] blocks: (int32 flat
    index into [F, nrows, 64], int16 value), in memory order. Their number
    comes back from the device: on the card this waits for the current
    stream."""
    F, n, _ = qout.shape
    flat = qout.reshape(-1)
    pos = torch.nonzero(flat).reshape(-1)
    idx = pos + (pos // (n * 64)) * ((nrows - n) * 64) + row0 * 64
    return idx.to(torch.int32), flat[pos]


class _MeState:
    """dispatch_me's result."""

    def __init__(self, F, planes_bs, cur, kf_flags, plan, keep):
        self.F = F
        self.planes_bs = planes_bs  # host planes, or None for device ones
        self.cur = cur              # [F, h, w] uint8 device planes per pli
        self.kf_flags = kf_flags
        self.plan = plan            # the ME plan's Download, or None
        self.keep = keep            # pinned sources of the uploads
        # G > 1: the chunk is G GOPs of equal length, which the plane
        # scans run side by side on their GOP axis (parallel/gop.py sets
        # it); 1: one scan over the chunk's frames.
        self.gop_axis = 1
        # None, or this rank's frag group of more than one rank
        # (parallel/ranks.py FragGroup, set by parallel/gop.py): the plane
        # scans encode the rank's share of every frame's fragments.
        self.frag = None


class _ChunkState:
    """complete_dispatch's result."""

    def __init__(self, F, plan_pf, frame_frag, fqis, kf_flags, qout,
                 download, K, want_recon, keep):
        # qout None: a frag rank other than its group's first, which
        # packs nothing.
        self.F = F
        self.plan_pf = plan_pf
        self.frame_frag = frame_frag
        self.fqis = fqis
        self.kf_flags = kf_flags
        self.qout = qout            # [F, n, 64] int16 per plane, on device
        self.download = download
        self.K = K
        self.want_recon = want_recon
        self.keep = keep


def trellis_bit_costs(huff_codes) -> np.ndarray:
    """The trellis' token bit costs [64, 32] float32 (its nb_full): per
    coefficient position, the code length of each token in the first
    Huffman table of the position's group, plus the token's extra
    bits."""
    nbt = np.zeros((5, 32), np.float32)
    for gi in range(5):
        for t in range(32):
            nbt[gi, t] = huff_codes[gi << 4][t][1] + DCT_TOKEN_EXTRA_BITS[t]
    return nbt[ZZI_GROUP]


def detect_scene_cuts(frames, keyframe_freq: int,
                      threshold: float = 24.0) -> list[int]:
    """GOP starts from pixels alone (tpu_gop.py:67-96): a frame opens a
    GOP when the mean absolute delta of its luma, subsampled 2x2, to its
    predecessor's exceeds threshold, or when its GOP has keyframe_freq
    frames. frames: list of [y, u, v] display-orientation planes. Returns
    the sorted start indices, 0 first."""
    starts = [0]
    prev = None
    for i, fr in enumerate(frames):
        y = np.asarray(fr[0]).astype(np.float32)[::2, ::2]
        if prev is not None:
            if (i - starts[-1] >= keyframe_freq
                    or float(np.abs(y - prev).mean()) > threshold):
                starts.append(i)
        prev = y
    return starts


def gop_starts(frames, keyframe_freq: int,
               auto_keyframe: bool = False) -> list[int]:
    """The clip's GOP start indices: fixed spacing, or at scene cuts
    (bounded by keyframe_freq) with auto_keyframe."""
    if auto_keyframe:
        return detect_scene_cuts(frames, keyframe_freq)
    return list(range(0, len(frames), keyframe_freq))


class GopEncoder:
    """Encode clips with ME, the closed-loop reconstruction and every
    pixel decision on `device` ("cuda" by default; "cpu" runs the plain
    PyTorch versions of the kernels). qinfo and huff_codes default to the
    spec tables (tables.py). rd_strength scales the skip test's, the qi
    chooser's and the R/D quantizer's lambda and the MV-bit bias of the
    mode decision. use_trellis: the trellis (kernel KT), else the R/D
    quantizer (kernel KR); set_splevel sets it. adaptive_quant: False,
    True or "auto" (encode/aq.py)."""

    def __init__(self, info: TheoraInfo, qi: int | None = None,
                 rd_strength: float = 3.0, use_trellis: bool = True,
                 device="cuda", qinfo: dict | None = None,
                 huff_codes: list | None = None,
                 adaptive_quant: bool | str = "auto"):
        self.device = resolve_device(device)
        self.rd_strength = float(rd_strength)
        self.adaptive_quant = adaptive_quant
        self.use_trellis = bool(use_trellis)
        self.sp_level = 0
        self._no_mc = False
        self.info = info
        self.packer = FramePacker(info, qinfo, huff_codes)
        self.g = g = self.packer.geometry
        self.dequant = self.packer.dequant
        self._mb_list = np.where(g.mb_valid)[0]
        frag0 = g.mb_maps[self._mb_list, 0, 0]
        self._mb_row = g.frag_y[frag0] // 2
        self._mb_col = g.frag_x[frag0] // 2
        # Per-MB luma block grid coordinates (mb_maps order) and whether
        # the MB has all 4 luma blocks (4MV eligibility).
        nh8 = g.planes[0].nhfrags
        lf = g.mb_maps[self._mb_list, 0]
        self._mb_birc = np.stack([lf // nh8, lf % nh8], axis=-1)
        self._mb_all4 = (lf >= 0).all(axis=1)
        self._nb = torch.from_numpy(
            trellis_bit_costs(self.packer.huff_codes)).to(self.device)
        self.set_qi(int(info.quality if qi is None else qi))
        # Host seconds of the mode decision (with the adaptive-quant
        # gates) and of the packing; the coded blocks packed at a qi other
        # than their frame's base qi; and, when device_spans is set to a
        # list, a (start, end) CUDA event pair around the work each chunk
        # enqueues for its ME and for its plane encodes. Once the stages
        # overlap, a span also holds any device idle time between the two
        # enqueues.
        self.host_decide_s = 0.0
        self.host_pack_s = 0.0
        self.nonbase_qi_blocks = 0
        self.device_spans: list[tuple] | None = None
        # Host seconds the stages spend waiting for the device's copies.
        self.host_wait_s = 0.0
        self._side = None  # finish_gop's copy stream, made at first use

    def _span(self):
        """A started CUDA event pair when spans are being kept."""
        if self.device.type != "cuda" or self.device_spans is None:
            return None
        span = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        span[0].record()
        return span

    def _end_span(self, span) -> None:
        if span is not None:
            span[1].record()
            self.device_spans.append(span)

    @property
    def adaptive_quant(self) -> bool | str:
        return self._adaptive_quant

    @adaptive_quant.setter
    def adaptive_quant(self, value) -> None:
        self._adaptive_quant = aq.check_mode(value)

    def set_splevel(self, lvl: int) -> None:
        """Speed levels (tpu_gop.py:609-618), clipped to 0-4: 0-1 the
        trellis, 2-3 the R/D quantizer and one qi per frame, 4 also no
        motion compensation (the MV modes priced out of the decision)."""
        lvl = int(np.clip(lvl, 0, 4))
        self.sp_level = lvl
        self.use_trellis = lvl < 2
        self._no_mc = lvl >= 4

    # ------------------------------------------------------------------
    def set_qi(self, qi: int) -> None:
        """Set the quantizer and the parameters derived from it."""
        self.qi = int(np.clip(qi, 0, 63))
        dq = self.dequant
        # Rate cost in SAD units tracks the quantizer step.
        self._bias_scale = min(
            1.0, float(dq[self.qi, 0, 1, 1]) / float(dq[40, 0, 1, 1]))
        self._mv_bits_sad = (
            28 * int(self.rd_strength * 4 + 4) * self._bias_scale)

    def _lam_t_for(self, qi: int):
        """DCT-domain trellis lambdas (intra, inter) at a qi."""
        rdl = RD_LAMBDA.get(int(self.info.pixel_fmt), RD_LAMBDA[0])
        return (float(rdl[0][qi]), float(rdl[1][qi]))

    def flush_headers(self) -> list[Packet]:
        return self.packer.flush_headers()

    # ------------------------------------------------------------------
    def _decide_frames(self, outs, rows):
        """Host mode decision for the plan rows `rows` of the downloaded
        ME plan (numpy int32 arrays). Returns {row: (mb_modes, mb_mvs,
        mb_bmvs)}."""
        (mv, sad_mv, sad_nomv, sad_gold, sad_intra, cands, cand_sads, gmv,
         sad_gmv, bmv, bsad) = outs
        g = self.g
        return {
            fi: mode_decide_native(
                self._mb_list, self._mb_row, self._mb_col, self._mb_all4,
                self._mb_birc, mv[fi], sad_mv[fi], sad_nomv[fi],
                sad_gold[fi], sad_intra[fi], cands[fi], cand_sads[fi],
                gmv[fi], sad_gmv[fi], bmv[fi], bsad[fi], g.nmbs,
                self._bias_scale, self._mv_bits_sad, self._no_mc)
            for fi in rows
        }

    def _frag_plan(self, mb_modes, mb_mvs, mb_bmvs):
        """Per-fragment refsel (0 intra, 1 prev, 2 gold), MV and may-skip
        from the MB plan; 4MV chroma vectors by the decoder's per-format
        derivation (state.c:33-97)."""
        g = self.g
        refsel = np.zeros(g.nfrags, dtype=np.int8)
        frag_mv = np.zeros((g.nfrags, 2), dtype=np.int32)
        may_skip = np.zeros(g.nfrags, dtype=bool)
        maps = g.mb_maps[self._mb_list]          # [nmb, 3, 4]
        modes = mb_modes[self._mb_list]
        mvs = mb_mvs[self._mb_list]
        flat = maps.reshape(-1)
        ok = flat >= 0
        rep_modes = np.repeat(modes, 12)
        rep_mvs = np.repeat(mvs, 12, axis=0)
        refsel[flat[ok]] = _RS_OF[rep_modes[ok]]
        frag_mv[flat[ok]] = np.where(_MV_MODES[rep_modes[ok]][:, None],
                                     rep_mvs[ok], 0)
        pf = int(self.info.pixel_fmt)

        def div_round(v, shift, rval):
            return (int(v) + (-1 if v < 0 else 0) + rval) >> shift

        for i in np.where(modes == MODE_INTER_MV_FOUR)[0]:
            mbi = self._mb_list[i]
            lb = mb_bmvs[mbi]
            for bi in range(4):
                fragi = g.mb_maps[mbi, 0, bi]
                if fragi >= 0:
                    frag_mv[fragi] = lb[bi]
            cb = [(0, 0)] * 4
            if pf == 0:
                cb[0] = (div_round(lb[:, 0].sum(), 2, 2),
                         div_round(lb[:, 1].sum(), 2, 2))
            elif pf == 2:
                for k, (a, b) in enumerate(((0, 1), (2, 3))):
                    cb[k * 2] = (div_round(lb[a, 0] + lb[b, 0], 1, 1),
                                 div_round(lb[a, 1] + lb[b, 1], 1, 1))
            else:
                cb = [tuple(v) for v in lb]
            for pli in (1, 2):
                for bi in range(4):
                    fragi = g.mb_maps[mbi, pli, bi]
                    if fragi >= 0:
                        frag_mv[fragi] = cb[bi]
        # Luma: only NOMV blocks may skip (a mode rides on coded luma;
        # an untransmitted mode decodes as NOMV). Chroma: any mode.
        luma = maps[:, 0, :].reshape(-1)
        okl = luma >= 0
        may_skip[luma[okl]] = np.repeat(modes, 4)[okl] == MODE_INTER_NOMV
        chroma = maps[:, 1:, :].reshape(-1)
        may_skip[chroma[chroma >= 0]] = True
        return refsel, frag_mv, may_skip

    def _plane_inputs(self, pli, refsel, frag_mv, may_skip):
        """Scan inputs of one plane of one frame (host numpy)."""
        pl = self.g.planes[pli]
        sl = slice(pl.froffset, pl.froffset + pl.nfrags)
        qpx = 1 if (pli != 0 and not (self.info.pixel_fmt & 1)) else 0
        qpy = 1 if (pli != 0 and not (self.info.pixel_fmt & 2)) else 0
        rs = refsel[sl]
        dx = frag_mv[sl, 0] + 31
        dy = frag_mv[sl, 1] + 31
        mx, mx2 = MVMAP[qpx][dx], MVMAP2[qpx][dx]
        my, my2 = MVMAP[qpy][dy], MVMAP2[qpy][dy]
        return dict(rs=rs, o1y=my, o1x=mx, o2y=my + my2, o2x=mx + mx2,
                    u2=((mx2 != 0) | (my2 != 0)) & (rs != 0),
                    ms=may_skip[sl])

    # ------------------------------------------------------------------
    def dispatch_me(self, gop_frames: list | None = None,
                    device_planes=None, kf_flags: list | None = None):
        """Stage 1: upload a chunk's planes, enqueue the ME plan and start
        its copy to the host; nothing waits for the device.

        gop_frames: list of [y, u, v] display-orientation planes of frame
        size. device_planes: {pli: [F, h, w] uint8} on the encoder's
        device, bitstream orientation, frame size without padding
        (BatchDecoder.dispatch_batch's "dev"), in place of gop_frames: no
        pixel crosses to the host, and adaptive quantization's content
        gates are skipped, as in JAX (tpu_gop.py:1062-1066). kf_flags
        marks the keyframes of a multi-GOP chunk (kf_flags[0] must be
        True); None: frame 0 is the only one. Golden references follow
        each frame's own GOP keyframe. Returns the state complete_dispatch
        takes."""
        g = self.g
        keep: list = []
        if device_planes is not None:
            cur = [device_planes[pli] for pli in range(3)]
            F = int(cur[0].shape[0])
            for pli, t in enumerate(cur):
                want = (F,) + tuple(g.plane_shape(pli))
                if (t.device.type != self.device.type
                        or t.dtype != torch.uint8
                        or tuple(t.shape) != want):
                    raise ValueError(
                        f"device_planes[{pli}]: expected {want} uint8 on "
                        f"{self.device}, got {tuple(t.shape)} {t.dtype} on "
                        f"{t.device}")
            planes_bs = None
        else:
            planes_bs = [[np.ascontiguousarray(p[::-1], dtype=np.uint8)
                          for p in fr] for fr in gop_frames]
            F = len(planes_bs)
            with record_function("theora.enc.upload"):
                cur = [transfer.upload(np.stack([fr[pli] for fr in planes_bs]),
                                       self.device, keep)
                       for pli in range(3)]
        if kf_flags is None:
            kf_flags = [True] + [False] * (F - 1)
        if len(kf_flags) != F or not kf_flags[0]:
            raise ValueError("kf_flags must cover all frames and mark "
                             "frame 0 a keyframe")
        kf_flags = [bool(b) for b in kf_flags]
        span = self._span()
        plan = None
        if F > 1 and not all(kf_flags):
            gidx = np.zeros(F - 1, np.int64)
            last = 0
            for f in range(1, F):
                if kf_flags[f]:
                    last = f
                gidx[f - 1] = last
            with record_function("theora.enc.me"):
                outs = me_cuda.plan_with_gold(
                    cur[0], transfer.upload(gidx, self.device, keep))
            with record_function("theora.enc.download"):
                plan = transfer.Download(_narrow_plan(outs))
        self._end_span(span)
        return _MeState(F, planes_bs, cur, kf_flags, plan, keep)

    def complete_dispatch(self, me_state, want_recon: bool = False,
                          frame_qi: list | None = None):
        """Stage 2: wait for the ME plan's copy (its event, nothing queued
        after it), run the host mode decision and the per-frame qi lists,
        enqueue the three plane encodes (encode/scan.py) and start the
        copies finish_gop reads: per block its coded flag and, with more
        than one qi row, its qi index; the padded reconstruction with
        want_recon.

        frame_qi: each frame's base qi (rate control's per-frame
        quantizers); None: self.qi for every frame. A frame's base qi
        drives its qi list, lambdas, loop-filter limit and header; the
        mode decision keeps self.qi's. With me_state.gop_axis G > 1 the
        chunk is G GOPs of equal length F / G (kf_flags marking each one's
        first frame), and the plane scans run them side by side on the
        scan's GOP axis (parallel/gop.py), F / G frame steps of G GOPs
        each, in place of one F-long scan. With me_state.frag, a frag group
        of Fr > 1 ranks, the inputs of each plane are cut to this rank's
        fragments before their upload and the scans encode those only;
        afterwards the group's first rank gathers every rank's coefficients,
        coded flags and qi indices (JAX's out_specs P("gop", None, "frag"),
        parallel/gop.py:130-137) and alone copies and packs them: on the
        other ranks finish_gop returns no packets. Returns the state
        finish_gop takes."""
        st = me_state
        g = self.g
        F, kf_flags, cur, keep = st.F, st.kf_flags, st.cur, st.keep
        if frame_qi is not None and len(frame_qi) != F:
            raise ValueError("frame_qi must give one qi per frame")
        G = int(st.gop_axis)
        Fg = F // G if G >= 1 else 0
        if G < 1 or G > 1 and (Fg * G != F or kf_flags != (
                [True] + [False] * (Fg - 1)) * G):
            raise ValueError(f"gop_axis {G}: the chunk's {F} frames must "
                             f"be that many GOPs of equal length")
        host = None
        if st.plan is not None:
            t0 = time.perf_counter()
            host = _widen_plan(st.plan.wait())
            self.host_wait_s += time.perf_counter() - t0

        t0 = time.perf_counter()
        # Plan row f - 1 belongs to frame f; keyframes' rows are not read.
        plans = {} if host is None else self._decide_frames(
            host, [f - 1 for f in range(1, F) if not kf_flags[f]])
        plan_pf = [None if kf_flags[f] else plans[f - 1] for f in range(F)]
        kf_frag = (np.zeros(g.nfrags, np.int8),
                   np.zeros((g.nfrags, 2), np.int32),
                   np.zeros(g.nfrags, bool))
        frame_frag = [kf_frag if p is None else self._frag_plan(*p)
                      for p in plan_pf]
        fqis, luma_sc = self._frame_qis(st.planes_bs, kf_flags, frame_qi)
        self.host_decide_s += time.perf_counter() - t0

        dq = self.dequant
        dev = self.device
        # Each frame's qi list padded to the chunk's K by repeating its
        # base row, which the chooser never picks (equal output, dearer
        # signalling), so a padded frame still packs one qi.
        K = max(len(q) for q in fqis)
        rows = [list(q) + [q[0]] * (K - len(q)) for q in fqis]
        # The trellis' lambda of each row, keyed by the frame's type.
        lam_t = np.array([[self._lam_t_for(q)[0 if kf_flags[f] else 1]
                           for q in row] for f, row in enumerate(rows)],
                         np.float32)
        # Per frame, at its base qi: the loop-filter limit and the skip
        # test's and chooser's lambda.
        limits = [int(self.packer.qinfo["loop_filter_limits"][row[0]])
                  for row in rows]
        lam = np.array([rd_lambda(row[0], int(dq[row[0], 0, 1, 1]))
                        * self.rd_strength * 4.0 for row in rows],
                       np.float32)
        span = self._span()
        plane_out = []

        def by_gop(a):
            """A per-frame array, [F, ...] -> [G, F / G, ...]."""
            return a.reshape((G, Fg) + a.shape[1:])

        fr = st.frag
        for pli in range(3):
            pl = g.planes[pli]
            vpad, hpad = g.plane_padding(pli)
            per = [self._plane_inputs(pli, *frame_frag[f]) for f in range(F)]
            cut = None
            if fr is not None:
                # This rank's fragments ([F, n] -> [F, nl]); pads may skip.
                _, cut, pads = fr.shard(pl.nfrags)
                for p in per:
                    for k in p:
                        p[k] = p[k][cut]
                    p["ms"] = p["ms"] | pads
            with record_function("theora.enc.upload"):
                frag = {k: transfer.upload(by_gop(
                    np.stack([p[k] for p in per]).astype(np.int64)), dev,
                    keep) for k in ("rs", "o1y", "o1x", "o2y", "o2x")}
                for k in ("u2", "ms"):
                    frag[k] = transfer.upload(
                        by_gop(np.stack([p[k] for p in per])), dev, keep)
                # [F, K, 2, 64]: DC (slot 0) always quantizes with the base
                # qi.
                deq = dq[rows, pli].astype(np.int16)
                deq[:, :, :, 0] = deq[:, :1, :, 0]
                deq = transfer.upload(by_gop(deq), dev, keep)
                sc = None
                if pli == 0 and luma_sc is not None:
                    sc = transfer.upload(by_gop(
                        luma_sc if cut is None else luma_sc[:, cut]), dev,
                        keep)
            lam_q = None
            if not self.use_trellis:
                # The R/D quantizer's lambda of each row for an intra and
                # an inter block (tpu_gop.py:1151-1154).
                lam_q = by_gop(np.array(
                    [[[rd_lambda(q, int(dq[q, pli, t, 1])) * self.rd_strength
                       for t in (0, 1)] for q in row] for row in rows],
                    np.float32))
            h, w = g.plane_shape(pli)
            qout, coded, qii, recon = encode_plane(
                cur[pli].reshape(G, Fg, h, w), frag, kf_flags[:Fg], deq,
                by_gop(np.asarray(limits)), by_gop(lam), pl.nvfrags,
                pl.nhfrags, vpad, hpad, use_trellis=self.use_trellis,
                lam_t=by_gop(lam_t), nb=self._nb, lam_q=lam_q, lam_sc=sc,
                emit_recon=want_recon, frag_group=fr)
            plane_out.append((qout.view(F, *qout.shape[2:]),
                              coded.view(F, -1), qii.view(F, -1),
                              None if recon is None
                              else recon.view(F, *recon.shape[2:])))
        if fr is not None:
            plane_out = self._gather_first(fr, plane_out)
        self._end_span(span)
        if plane_out is None:
            return _ChunkState(F, plan_pf, frame_frag, fqis, kf_flags, None,
                               None, K, want_recon, keep)
        # The nonzero coefficients come down in finish_gop, once their
        # number is known.
        copies = []
        for _, coded, qii, recon in plane_out:
            copies.append(coded)
            if K > 1:
                copies.append(qii)
            if want_recon:
                copies.append(recon)
        with record_function("theora.enc.download"):
            download = transfer.Download(copies)
        return _ChunkState(F, plan_pf, frame_frag, fqis, kf_flags,
                           [o[0] for o in plane_out], download, K,
                           want_recon, keep)

    def finish_gop(self, state):
        """Stage 3: wait for the chunk's copies, find and bring down its
        nonzero coefficients (on a side stream that waits for this chunk
        only), place them and pack the packets on the host. Returns
        (packet data list, recon {pli: [F, Hp, Wp] uint8 padded planes}
        or None); the packets are None on a frag rank that packs
        nothing."""
        st = state
        if st.qout is None:
            return None, None
        g = self.g
        t0 = time.perf_counter()
        host = iter(st.download.wait())
        coded_pl, qii_pl, recon_pl = {}, {}, {}
        for pli in range(3):
            coded_pl[pli] = next(host)
            if st.K > 1:
                qii_pl[pli] = next(host)
            if st.want_recon:
                recon_pl[pli] = next(host)
        nonzeros = self._coefficients(st.qout, st.download.event)
        self.host_wait_s += time.perf_counter() - t0

        t0 = time.perf_counter()
        qdct = np.zeros((st.F, g.nfrags, 64), np.int16)
        for idx, vals in nonzeros:
            qdct.reshape(-1)[idx] = vals
        pkts = self._pack_gop(st.F, st.plan_pf, st.frame_frag, qdct,
                              coded_pl, st.kf_flags, st.fqis, qii_pl)
        self.host_pack_s += time.perf_counter() - t0
        return pkts, (recon_pl if st.want_recon else None)

    def _gather_first(self, fr, plane_out):
        """A chunk's per-plane (qout [F, nl, 64] int16, coded [F, nl] bool,
        qii [F, nl] uint8, recon) of every rank of the frag group fr, whole
        ([F, n, ...]) on its first rank, as one gather of each rank's bytes;
        None on the other ranks."""
        mine = torch.cat([torch.cat((q.view(torch.uint8),
                                     c[..., None].to(torch.uint8),
                                     i[..., None]), 2)
                          for q, c, i, _ in plane_out], 1)
        with record_function("theora.enc.frag_gather"):
            parts = fr.gather_first(mine, "chunk")
        if parts is None:
            return None
        out, off = [], 0
        for pli, (q, _, _, recon) in enumerate(plane_out):
            nl = q.shape[1]
            whole = fr.whole(parts[:, :, off:off + nl], self.g.planes[
                pli].nfrags, 1)
            off += nl
            out.append((whole[..., :128].contiguous().view(torch.int16),
                        whole[..., 128].bool(), whole[..., 129].contiguous(),
                        recon))
        return out

    def _coefficients(self, qouts, after) -> list[tuple]:
        """Per plane, the nonzero entries of its [F, n, 64] int16
        coefficients as _nonzeros gives them, indexed into the chunk's
        [F, nfrags, 64] blocks, as numpy. On the card they are found and
        copied on a side stream that waits for the event `after` only, so
        the work queued since on the main stream (the next chunk's) does
        not delay them."""
        g = self.g
        rows = [(g.planes[pli].froffset, g.nfrags) for pli in range(3)]
        if self.device.type != "cuda":
            return [tuple(t.numpy() for t in _nonzeros(q, *r))
                    for q, r in zip(qouts, rows)]
        if self._side is None:
            self._side = torch.cuda.Stream(self.device, priority=-1)
        self._side.wait_event(after)
        with torch.cuda.stream(self._side), \
                record_function("theora.enc.download"):
            found = []
            for q, r in zip(qouts, rows):
                q.record_stream(self._side)
                found += _nonzeros(q, *r)
            host = transfer.Download(found).wait()
        return list(zip(host[0::2], host[1::2]))

    def _frame_qis(self, planes_bs, kf_flags, frame_qi=None):
        """Per frame of a chunk its qi list (tpu_gop.py:1041-1123): the
        content gates on its luma plane (none for device planes,
        planes_bs None: not noise-like, not mixed, no lambda scales) and
        the adaptive-quantization triple at the frame's base qi
        (frame_qi[f], else self.qi), the intra one for a frame whose GOP
        is only a keyframe; one qi at speed levels 2-4. Returns (qi
        tuples, [F, n] float32 luma lambda scales or None where no frame
        with more than one qi engaged masking)."""
        F = len(kf_flags)
        starts = [f for f in range(F) if kf_flags[f]] + [F]
        gop_len = np.zeros(F, np.int64)
        for a, b in zip(starts, starts[1:]):
            gop_len[a:b] = b - a
        mode = self.adaptive_quant if self.sp_level < 2 else False
        fqis, frame_sc = [], [None] * F
        for f in range(F):
            base = (self.qi if frame_qi is None
                    else int(np.clip(frame_qi[f], 0, 63)))
            nl, mixed, sc = (aq.frame_gates(planes_bs[f][0], mode)
                             if mode and planes_bs is not None
                             else (False, False, None))
            fqis.append(aq.frame_qis(mode, base,
                                     int(self.info.pixel_fmt),
                                     gop_len[f] == 1, nl, mixed,
                                     sc is not None))
            if sc is not None and len(fqis[-1]) > 1:
                frame_sc[f] = sc
        if all(s is None for s in frame_sc):
            return fqis, None
        luma_sc = np.ones((F, self.g.planes[0].nfrags), np.float32)
        for f, sc in enumerate(frame_sc):
            if sc is not None:
                luma_sc[f] = sc.astype(np.float32)
        return fqis, luma_sc

    def _pack_gop(self, F, plans, frame_frag, qdct_f, coded_pl, kf_flags,
                  fqis, qii_pl):
        """Packets of a chunk's frames; qdct_f: [F, nfrags, 64] int16."""
        g = self.g
        pkts = []
        for f in range(F):
            qdct = qdct_f[f]
            coded = np.zeros(g.nfrags, bool)
            qis = fqis[f] if len(fqis[f]) > 1 else None
            frag_qii = None if qis is None else np.zeros(g.nfrags, np.int32)
            for pli in range(3):
                pl = g.planes[pli]
                sl = slice(pl.froffset, pl.froffset + pl.nfrags)
                coded[sl] = coded_pl[pli][f]
                if qis is not None:
                    frag_qii[sl] = qii_pl[pli][f]
            if qis is not None:
                self.nonbase_qi_blocks += int(np.count_nonzero(
                    frag_qii[coded]))
            rs, fmv, _ = frame_frag[f]
            frag_refi = np.where(coded, _RS_TO_REF[rs.astype(np.int32)],
                                 FRAME_NONE).astype(np.int32)
            # The frame's own base qi goes into its header.
            if kf_flags[f]:
                data = self.packer.pack_frame_plan(
                    INTRA_FRAME, fqis[f][0], coded, frag_refi, None, None,
                    qdct, qis=qis, frag_qii=frag_qii)
            else:
                mb_modes, mb_mvs = plans[f][:2]
                data = self.packer.pack_frame_plan(
                    INTER_FRAME, fqis[f][0], coded, frag_refi, mb_modes,
                    mb_mvs, qdct, frag_mv4=fmv, qis=qis, frag_qii=frag_qii)
            pkts.append(data)
        return pkts

    # ------------------------------------------------------------------
    def dispatch_gop(self, gop_frames: list | None = None,
                     want_recon: bool = False, device_planes=None,
                     frame_qi: list | None = None):
        """Stages 1 and 2 for one GOP (frame 0 its keyframe): enqueue all
        its device work; returns the state finish_gop takes."""
        return self.complete_dispatch(
            self.dispatch_me(gop_frames, device_planes=device_planes),
            want_recon=want_recon, frame_qi=frame_qi)

    def encode_gop(self, gop_frames: list, want_recon: bool = False):
        """Encode one GOP (frame 0 becomes the keyframe). Returns (packet
        data list, recon {pli: [F, Hp, Wp]} or None)."""
        return self.finish_gop(self.dispatch_gop(gop_frames,
                                                 want_recon=want_recon))

    def _pipelined(self, dispatched, emit) -> None:
        """Run chunks two deep (tpu_gop.py:1460-1482): `dispatched` yields
        (tag, dispatch_me state) per chunk, dispatching as it is read;
        chunk k's complete_dispatch runs after chunk k+1's dispatch_me,
        and its finish_gop, then emit(tag, packet data list), after chunk
        k+1's complete_dispatch."""
        me_q: deque = deque()
        fin_q: deque = deque()

        def drain_complete():
            tag, st = me_q.popleft()
            fin_q.append((tag, self.complete_dispatch(st)))

        def drain_finish():
            tag, st = fin_q.popleft()
            emit(tag, self.finish_gop(st)[0])

        for item in dispatched:
            me_q.append(item)
            if len(me_q) >= 2:
                drain_complete()
            if len(fin_q) >= 2:
                drain_finish()
        while me_q:
            drain_complete()
        while fin_q:
            drain_finish()

    def _emit(self, out: list, datas, kf, pbase: int, nf: int) -> None:
        """Append the packets of frames pbase.. (kf marks their keyframes)
        with their granule positions; packet numbers continue from out."""
        shift = self.info.keyframe_granule_shift
        gop_base = pbase
        for k, data in enumerate(datas):
            fnum = pbase + k
            if kf[k]:
                gop_base = fnum
            gp = ((gop_base + 1) << shift) + (fnum - gop_base)
            out.append(Packet(data, granulepos=gp, packetno=len(out),
                              e_o_s=(fnum == nf - 1)))

    def encode_clip(self, frames: list, keyframe_freq: int = 8,
                    target_bitrate: int = 0, rate_window: int = 8,
                    auto_keyframe: bool = False,
                    clip_batch: int = 8) -> list[Packet]:
        """Headers + data packets for a whole clip: consecutive GOPs ride
        one chunk of at most clip_batch frames (a GOP longer than that is
        a chunk of its own); the plane encodes restart at every keyframe,
        so the bytes equal per-GOP encodes. auto_keyframe places keyframes
        at scene cuts (detect_scene_cuts). The chunks run two deep
        (_pipelined): chunk k+1's upload and ME are queued before chunk
        k's plane encodes, and its plane encodes before chunk k's packing,
        so the host's mode decision and packing overlap the device's work.

        With target_bitrate > 0 each GOP is a chunk of its own, run stage
        after stage, and the fixed-window controller (WindowRateController)
        moves the qi from the real packed bits every rate_window GOPs and
        once at the end (tpu_gop.py:1394-1418)."""
        out = self.flush_headers()
        nf = len(frames)
        bases = gop_starts(frames, keyframe_freq, auto_keyframe)
        bounds = bases + [nf]
        gops = [frames[bases[k]:bounds[k + 1]] for k in range(len(bases))]
        if target_bitrate > 0:
            rc = WindowRateController(self, target_bitrate, rate_window)
            for gi, gfr in enumerate(gops):
                datas, _ = self.encode_gop(gfr)
                self._emit(out, datas, [True] + [False] * (len(gfr) - 1),
                           bases[gi], nf)
                rc.add(8 * sum(len(d) for d in datas), len(datas))
                if (gi + 1) % rate_window == 0:
                    rc.update()
            rc.update()
            return out
        chunk_max = max(int(clip_batch), 1)
        chunks = []  # (first frame, frames, kf_flags)
        i = 0
        while i < len(gops):
            j, total = i, 0
            while j < len(gops) and (j == i
                                     or total + len(gops[j]) <= chunk_max):
                total += len(gops[j])
                j += 1
            cfr, kf = [], []
            for k in range(i, j):
                cfr.extend(gops[k])
                kf.extend([True] + [False] * (len(gops[k]) - 1))
            chunks.append((bases[i], cfr, kf))
            i = j
        self._pipelined(
            (((base, kf), self.dispatch_me(cfr, kf_flags=kf))
             for base, cfr, kf in chunks),
            lambda tag, datas: self._emit(out, datas, tag[1], tag[0], nf))
        return out

    def _rc_info(self, target_bitrate: int) -> TheoraInfo:
        """A copy of the stream info with the rate target set, for the
        controller only: the packed headers keep the caller's info."""
        rc_info = copy.copy(self.info)
        rc_info.target_bitrate = int(target_bitrate)
        return rc_info

    def encode_clip_pass1(self, frames: list, keyframe_freq: int = 8,
                          target_bitrate: int = 0,
                          auto_keyframe: bool = False):
        """2-pass, pass 1 (tpu_gop.py:1484-1526): a fixed-qi encode_clip
        at the qi the controller's pass 1 picks, then the controller
        replayed over the real packet sizes. Returns (packets, OT2P
        metrics blob in the reference's format)."""
        rc = RateControl(self._rc_info(target_bitrate), keyframe_freq)
        rc.start_pass1()
        saved_qi = self.qi
        self.set_qi(rc._pass1_qi)
        try:
            pkts = self.encode_clip(frames, keyframe_freq=keyframe_freq,
                                    auto_keyframe=auto_keyframe)
        finally:
            self.set_qi(saved_qi)
        kf_set = set(gop_starts(frames, keyframe_freq, auto_keyframe))
        qi = rc._pass1_qi
        body = b""
        for j, p in enumerate(pkts[3:]):
            ftype = 0 if j in kf_set else 1
            qi = rc.select_qi(ftype, qi)
            rc.update(ftype, qi, 8 * len(p.data))
            body += rc.pass1_frame_data()
        return pkts, rc.pass1_summary() + body

    def encode_clip_pass2(self, frames: list, pass1_data: bytes,
                          keyframe_freq: int = 8, target_bitrate: int = 0,
                          buf_delay: int | None = None,
                          rate_window: int = 1,
                          auto_keyframe: bool = False) -> list[Packet]:
        """2-pass, pass 2 (tpu_gop.py:1540-1617): per window of
        rate_window GOPs, every frame's qi from the controller's model
        pre-pass (twopass_window_qvecs) from the window-start state; the
        GOPs encode at those qis (one chunk each), and the controller
        replays each frame with its real packed bits."""
        rc = RateControl(self._rc_info(target_bitrate), keyframe_freq)
        rc.start_pass2(pass1_data, buf_delay)
        out = self.flush_headers()
        nf = len(frames)
        bases = gop_starts(frames, keyframe_freq, auto_keyframe)
        bounds = bases + [nf]
        gops = [(bases[k], frames[bases[k]:bounds[k + 1]])
                for k in range(len(bases))]
        applied_qi = self.qi
        for w0 in range(0, len(gops), rate_window):
            window = gops[w0:w0 + rate_window]
            qvecs = twopass_window_qvecs(
                rc, [len(gfr) for _, gfr in window], applied_qi)
            prev_applied = applied_qi
            for (base, gfr), qv in zip(window, qvecs):
                datas, _ = self.finish_gop(self.dispatch_gop(gfr,
                                                             frame_qi=qv))
                self._emit(out, datas, [True] + [False] * (len(gfr) - 1),
                           base, nf)
                for j, data in enumerate(datas):
                    ftype = 0 if j == 0 else 1
                    # The controller's own selection is discarded: the
                    # frame's qi was fixed by the pre-pass.
                    rc.select_qi(ftype, prev_applied)
                    rc.log_qtarget = rc.log_qavg[ftype][qv[j]]
                    rc.update(ftype, qv[j], 8 * len(data))
                    prev_applied = qv[j]
            applied_qi = prev_applied
        return out

    def encode_clip_twopass(self, frames: list, keyframe_freq: int = 8,
                            target_bitrate: int = 0,
                            buf_delay: int | None = None,
                            rate_window: int = 1,
                            auto_keyframe: bool = False):
        """Pass 1 and pass 2; returns (packets, pass-1 metrics blob)."""
        _, blob = self.encode_clip_pass1(frames, keyframe_freq,
                                         target_bitrate, auto_keyframe)
        pkts = self.encode_clip_pass2(frames, blob, keyframe_freq,
                                      target_bitrate, buf_delay,
                                      rate_window, auto_keyframe)
        return pkts, blob


def transcode_device(info, setup, data_packets, keyframe_freq: int = 8,
                     qi: int = 40, target_bitrate: int = 0,
                     rate_window: int = 8, enc_kwargs: dict | None = None):
    """Device-resident transcode (tpu_gop.py:1636-1754): BatchDecoder's
    decoded planes feed GopEncoder.dispatch_me on the card; no decoded
    pixel is copied to the host.

    data_packets: the input stream's data packets (its headers parsed into
    info and setup). Decode batches of keyframe_freq packets; each becomes
    one output GOP, a keyframe every keyframe_freq frames. enc_kwargs go
    to GopEncoder (device among them: "cuda" by default), and the decoder
    runs on the encoder's device. Without a target bitrate batch k+1's
    decode and ME are queued before batch k's plane encodes, and those
    before batch k-1's packing (_pipelined); with one, the batches run in
    turn under WindowRateController. Returns the output packets, headers
    first.

    A dup (0-byte) packet repeats the latest frame before it, and a batch
    of dups only the previous batch's last frame. A dup that leads a
    batch takes the previous batch's last frame too, as the output must
    equal a host decode fed to encode_clip; the JAX function gives it
    the batch's last live frame, a later one. Device planes skip
    adaptive quantization's content gates, as in JAX."""
    enc = GopEncoder(info, qi=qi, **(enc_kwargs or {}))
    dec = BatchDecoder(info, setup, device=enc.device)
    out = enc.flush_headers()
    nf = len(data_packets)
    bases = range(0, nf, keyframe_freq)
    last = None  # the latest frame given to the encoder, {pli: [h, w]}

    def decode(base):
        nonlocal last
        chunk = data_packets[base:base + keyframe_freq]
        st = dec.dispatch_batch(chunk)
        emit = [-1] * len(chunk) if st is None else st["emit"]
        if emit == list(range(len(chunk))):
            planes = st["dev"]
        else:
            if last is None and emit[0] < 0:
                raise ValueError("stream must start with a live frame")
            planes = {pli: torch.stack([last[pli] if li < 0
                                        else st["dev"][pli][li]
                                        for li in emit])
                      for pli in range(3)}
        last = {pli: planes[pli][-1] for pli in range(3)}
        return planes

    def emit_gop(base, datas):
        enc._emit(out, datas, [True] + [False] * (len(datas) - 1), base, nf)

    if target_bitrate > 0:
        rc = WindowRateController(enc, target_bitrate, rate_window)
        for gi, base in enumerate(bases):
            datas, _ = enc.finish_gop(
                enc.dispatch_gop(device_planes=decode(base)))
            emit_gop(base, datas)
            rc.add(8 * sum(len(d) for d in datas), len(datas))
            if (gi + 1) % rate_window == 0:
                rc.update()
        rc.update()
        return out
    enc._pipelined(((base, enc.dispatch_me(device_planes=decode(base)))
                    for base in bases), emit_gop)
    return out


class WindowRateController:
    """Fixed-window CBR (tpu_gop.py:1756-1794): between GOP windows, steer
    the encoder's qi from the real packed bit counts."""

    def __init__(self, enc: GopEncoder, target_bitrate: int,
                 rate_window: int):
        self.enc = enc
        self.target_bitrate = int(target_bitrate)
        info = enc.info
        self.fps = max(info.fps_numerator / max(info.fps_denominator, 1),
                       1e-6)
        self.rate_window = int(rate_window)
        self.fullness = 0.0
        self.win_bits = 0
        self.win_frames = 0

    def add(self, bits: int, nframes: int) -> None:
        self.win_bits += int(bits)
        self.win_frames += int(nframes)

    def update(self) -> None:
        self.apply(self.win_bits, self.win_frames)
        self.win_bits = 0
        self.win_frames = 0

    def apply(self, total_bits: int, nframes: int) -> None:
        """Move the qi by at most 4 after a window of nframes frames that
        took total_bits."""
        if nframes == 0:
            return
        target = self.target_bitrate * nframes / self.fps
        self.fullness += target - total_bits
        step = int(round(-self.fullness / max(target / 2, 1.0)))
        if step:
            self.enc.set_qi(self.enc.qi + int(np.clip(step, -4, 4)))
