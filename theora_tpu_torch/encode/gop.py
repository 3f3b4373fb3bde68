"""Device GOP encoder: motion estimation, the closed-loop plane encode and
the reconstruction on the card; mode decision and entropy coding on the
host.

Port of theora_tpu/encode/tpu_gop.py (`TpuGopEncoder`: the constructor,
`set_qi`, `_lam_t_for`, `_decide_frames`, `_frag_plan`, `_plane_inputs`,
`dispatch_me`, `complete_dispatch` and `finish_gop` (one `_encode_chunk`
here), `_pack_gop`, `encode_gop`, `encode_clip` and `gop_starts`) for the
configuration the port supports: a fixed qi, the trellis at the default
rd_strength, no adaptive quantization, no rate control and fixed keyframe
spacing. Its packets are byte-identical to the JAX encoder's in that
configuration.

Per chunk of frames (consecutive GOPs, `clip_batch` frames at most):
  1. upload the luma stack; the ME plan (ops/me.py) on the device;
  2. download the plan; the host's sequential mode decision
     (native `mode_decide_native`) and per-fragment plan;
  3. per plane, the closed-loop encode (encode/scan.py: kernels K2 and
     K1) on the device;
  4. download the coded flags, nonzero counts and the nonzero
     coefficients (sized by their true count), then pack on the host
     (encode/packer.py).
The chunks run one after the other: GOPs are independent, so overlapping
them could not change a byte.
"""
from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from theora_tpu_torch import resolve_device
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
    ZZI_GROUP,
)
from theora_tpu_torch.decode.decoder import _MVMAP, _MVMAP2
from theora_tpu_torch.encode.packer import FramePacker
from theora_tpu_torch.encode.scan import encode_plane
from theora_tpu_torch.info import INTER_FRAME, INTRA_FRAME, TheoraInfo
from theora_tpu_torch.native import mode_decide_native
from theora_tpu_torch.ops import me
from theora_tpu_torch.ops.transforms import rd_lambda
from theora_tpu_torch.tables import RD_LAMBDA
from theora_tpu_torch.tpkt import Packet

# The settings of the JAX encoder this port does not carry yet, each with
# the ROADMAP.md item that ports it.
_TODO = {
    "adaptive_quant": "adaptive quantization (ROADMAP.md section 1, "
                      "'Adaptive quant')",
    "use_trellis": "speed levels 2-4 and quantize_rd (ROADMAP.md section "
                   "1, 'Speed levels')",
    "target_bitrate": "CBR and 2-pass rate control (ROADMAP.md section 1, "
                      "'Rate control')",
    "auto_keyframe": "scene-cut keyframes (ROADMAP.md section 1, "
                     "'Scene-cut keyframes')",
}

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
# The JAX encoder's default R/D strength: it scales the skip test's lambda
# and the MV-bit bias of the mode decision.
RD_STRENGTH = 3.0


def _unsupported(what: str):
    raise NotImplementedError(
        f"{what} is not ported to theora_tpu_torch yet: {_TODO[what]}")


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


def gop_starts(frames, keyframe_freq: int,
               auto_keyframe: bool = False) -> list[int]:
    """The clip's GOP start indices at fixed spacing."""
    if auto_keyframe:
        _unsupported("auto_keyframe")
    return list(range(0, len(frames), keyframe_freq))


class GopEncoder:
    """Encode clips with ME, the closed-loop reconstruction and every
    pixel decision on `device` ("cuda" by default; "cpu" runs the plain
    PyTorch versions of the kernels). qinfo and huff_codes default to the
    spec tables (tables.py)."""

    def __init__(self, info: TheoraInfo, qi: int | None = None,
                 use_trellis: bool = True,
                 device="cuda", qinfo: dict | None = None,
                 huff_codes: list | None = None,
                 adaptive_quant: bool = False):
        self.device = resolve_device(device)
        self.adaptive_quant = adaptive_quant
        self.use_trellis = use_trellis
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
        # Host seconds of the mode decision and of the packing; and, when
        # device_spans is set to a list, a (start, end) CUDA event pair
        # around each chunk's ME and around its plane encodes.
        self.host_decide_s = 0.0
        self.host_pack_s = 0.0
        self.device_spans: list[tuple] | None = None

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
    def adaptive_quant(self) -> bool:
        return False

    @adaptive_quant.setter
    def adaptive_quant(self, value) -> None:
        if value is not False:
            _unsupported("adaptive_quant")

    @property
    def use_trellis(self) -> bool:
        return True

    @use_trellis.setter
    def use_trellis(self, value) -> None:
        if not value:
            _unsupported("use_trellis")

    # ------------------------------------------------------------------
    def set_qi(self, qi: int) -> None:
        """Set the quantizer and the parameters derived from it."""
        self.qi = int(np.clip(qi, 0, 63))
        dq = self.dequant
        # Rate cost in SAD units tracks the quantizer step.
        self._bias_scale = min(
            1.0, float(dq[self.qi, 0, 1, 1]) / float(dq[40, 0, 1, 1]))
        self._mv_bits_sad = (
            28 * int(RD_STRENGTH * 4 + 4) * self._bias_scale)
        self._lam_t = self._lam_t_for(self.qi)

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
                self._bias_scale, self._mv_bits_sad)
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
        mx, mx2 = _MVMAP[qpx][dx], _MVMAP2[qpx][dx]
        my, my2 = _MVMAP[qpy][dy], _MVMAP2[qpy][dy]
        return dict(rs=rs, o1y=my, o1x=mx, o2y=my + my2, o2x=mx + mx2,
                    u2=((mx2 != 0) | (my2 != 0)) & (rs != 0),
                    ms=may_skip[sl])

    # ------------------------------------------------------------------
    def _encode_chunk(self, frames: list, kf_flags: list | None = None,
                      want_recon: bool = False):
        """Encode a chunk of frames: ME on the device, the host mode
        decision, the per-plane closed-loop encodes on the device, then
        the download and the host packing.

        frames: list of [y, u, v] display-orientation planes of frame
        size. kf_flags marks the keyframes of a multi-GOP chunk
        (kf_flags[0] must be True); None: frame 0 is the only one. Golden
        references follow each frame's own GOP keyframe. Returns (packet
        data list, recon {pli: [F, Hp, Wp] uint8 padded planes} or None).
        """
        g = self.g
        F = len(frames)
        if kf_flags is None:
            kf_flags = [True] + [False] * (F - 1)
        if len(kf_flags) != F or not kf_flags[0]:
            raise ValueError("kf_flags must cover all frames and mark "
                             "frame 0 a keyframe")
        kf_flags = [bool(b) for b in kf_flags]
        planes_bs = [[np.ascontiguousarray(p[::-1], dtype=np.uint8)
                      for p in fr] for fr in frames]
        span = self._span()
        ys = torch.from_numpy(np.stack([fr[0] for fr in planes_bs])).to(
            self.device)
        me_outs = None
        if F > 1 and not all(kf_flags):
            gidx = np.zeros(F - 1, np.int64)
            last = 0
            for f in range(1, F):
                if kf_flags[f]:
                    last = f
                gidx[f - 1] = last
            with record_function("theora.enc.me"):
                me_outs = me.plan_with_gold(
                    ys, torch.from_numpy(gidx).to(self.device))
        self._end_span(span)
        host = None
        if me_outs is not None:
            with record_function("theora.enc.download"):
                host = [o.cpu().numpy() for o in me_outs]

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
        self.host_decide_s += time.perf_counter() - t0

        qi = self.qi
        dq = self.dequant
        lam_t = np.array(self._lam_t, np.float32)
        limit = int(self.packer.qinfo["loop_filter_limits"][qi])
        lam = np.float32(rd_lambda(qi, int(dq[qi, 0, 1, 1]))
                         * RD_STRENGTH * 4.0)
        span = self._span()
        plane_out = {}
        for pli in range(3):
            pl = g.planes[pli]
            vpad, hpad = g.plane_padding(pli)
            per = [self._plane_inputs(pli, *frame_frag[f]) for f in range(F)]
            frag = {}
            for k in ("rs", "o1y", "o1x", "o2y", "o2x"):
                frag[k] = torch.from_numpy(
                    np.stack([p[k] for p in per]).astype(np.int64)).to(
                        self.device)
            for k in ("u2", "ms"):
                frag[k] = torch.from_numpy(np.stack([p[k] for p in per])).to(
                    self.device)
            cur = ys if pli == 0 else torch.from_numpy(
                np.stack([planes_bs[f][pli] for f in range(F)])).to(
                    self.device)
            deq = torch.from_numpy(dq[qi, pli].astype(np.int16)).to(
                self.device)
            plane_out[pli] = encode_plane(
                cur, frag, kf_flags, deq, limit, lam, lam_t, self._nb,
                pl.nvfrags, pl.nhfrags, vpad, hpad, emit_recon=want_recon)
        self._end_span(span)

        qdct_pl, coded_pl, recon_pl = {}, {}, {}
        for pli, (qout, coded, nnz, recon) in plane_out.items():
            # Only the nonzero coefficients come down, as (zig-zag index,
            # value) pairs in block order; the counts place them.
            with record_function("theora.enc.download"):
                flat = qout.reshape(-1)
                pos = torch.nonzero(flat).reshape(-1)
                zzi = (pos & 63).to(torch.uint8).cpu().numpy()
                vals = flat[pos].cpu().numpy()
                counts = nnz.cpu().numpy().reshape(-1)
                coded_pl[pli] = coded.cpu().numpy()
                if want_recon:
                    recon_pl[pli] = recon.cpu().numpy()
            dense = np.zeros((counts.size, 64), np.int16)
            dense[np.repeat(np.arange(counts.size), counts), zzi] = vals
            qdct_pl[pli] = dense.reshape(F, -1, 64)
        t0 = time.perf_counter()
        pkts = self._pack_gop(F, plan_pf, frame_frag, qdct_pl, coded_pl,
                              kf_flags)
        self.host_pack_s += time.perf_counter() - t0
        return pkts, (recon_pl if want_recon else None)

    def _pack_gop(self, F, plans, frame_frag, qdct_pl, coded_pl, kf_flags):
        g = self.g
        pkts = []
        for f in range(F):
            qdct = np.zeros((g.nfrags, 64), np.int16)
            coded = np.zeros(g.nfrags, bool)
            for pli in range(3):
                pl = g.planes[pli]
                sl = slice(pl.froffset, pl.froffset + pl.nfrags)
                qdct[sl] = qdct_pl[pli][f]
                coded[sl] = coded_pl[pli][f]
            rs, fmv, _ = frame_frag[f]
            frag_refi = np.where(coded, _RS_TO_REF[rs.astype(np.int32)],
                                 FRAME_NONE).astype(np.int32)
            if kf_flags[f]:
                data = self.packer.pack_frame_plan(
                    INTRA_FRAME, self.qi, coded, frag_refi, None, None, qdct)
            else:
                mb_modes, mb_mvs = plans[f][:2]
                data = self.packer.pack_frame_plan(
                    INTER_FRAME, self.qi, coded, frag_refi, mb_modes, mb_mvs,
                    qdct, frag_mv4=fmv)
            pkts.append(data)
        return pkts

    # ------------------------------------------------------------------
    def encode_gop(self, gop_frames: list, want_recon: bool = False):
        """Encode one GOP (frame 0 becomes the keyframe). Returns (packet
        data list, recon {pli: [F, Hp, Wp]} or None)."""
        return self._encode_chunk(gop_frames, want_recon=want_recon)

    def encode_clip(self, frames: list, keyframe_freq: int = 8,
                    target_bitrate: int = 0, auto_keyframe: bool = False,
                    clip_batch: int = 8) -> list[Packet]:
        """Headers + data packets for a whole clip: consecutive GOPs ride
        one chunk of at most clip_batch frames (a GOP longer than that is
        a chunk of its own); the plane encodes restart at every keyframe,
        so the bytes equal per-GOP encodes."""
        if target_bitrate > 0:
            _unsupported("target_bitrate")
        out = self.flush_headers()
        shift = self.info.keyframe_granule_shift
        nf = len(frames)
        bases = gop_starts(frames, keyframe_freq, auto_keyframe)
        bounds = bases + [nf]
        gops = [frames[bases[k]:bounds[k + 1]] for k in range(len(bases))]
        chunk_max = max(int(clip_batch), 1)
        pno = 3
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
            pbase = bases[i]
            datas, _ = self._encode_chunk(cfr, kf_flags=kf)
            gop_base = pbase
            for k, data in enumerate(datas):
                fnum = pbase + k
                if kf[k]:
                    gop_base = fnum
                gp = ((gop_base + 1) << shift) + (fnum - gop_base)
                out.append(Packet(data, granulepos=gp, packetno=pno,
                                  e_o_s=(fnum == nf - 1)))
                pno += 1
            i = j
        return out
