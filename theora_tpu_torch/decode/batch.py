"""GOP-batch decode on the card: host entropy for all frames of a batch up
front, then per plane one dequant + iDCT launch (kernel K1) over every
frame's blocks and a Python loop over frames for MC and reconstruction
(kernel KS's decode entry, one launch per plane of a frame, which also
fills the borders and the output frame of a frame whose limit is 0) and
the loop filter and borders (kernel KL, one launch per plane of a frame
whose limit is above 0), with the reference planes carried on the
device. With a postprocessing level set (set_pplevel), kernel KP
deblocks and derings each postprocessed plane of a frame into the output
frame, from the frame's unpadded image; the references stay as decoded.
Telemetry overlays are drawn on the downloaded display-orientation frame
(decode/telemetry.py), as the JAX decoder draws them.

Port of theora_tpu/decode/tpu_batch.py (`TpuBatchDecoder`). The JAX scan
over frames becomes a loop; dequant + iDCT reads no carried plane, so it
runs once per plane per batch instead of once per scan step.

Transfers:
- UP: coefficients go up sparse, as per-fragment nonzero-AC counts
  (uint8), zig-zag positions (uint8) and values (int16), and are expanded
  on the device by one index_put.
- DOWN: only the uint8 frame planes without their UMV padding, copied
  asynchronously into pinned host buffers.
- Reference planes stay resident on the device between batches.
Uploads and downloads go through pinned host buffers without waiting on
the stream (transfer.py), so a batch's device work queues behind the
previous batch's without the host waiting for it. dispatch_batch's
planes can stay on the card: encode/gop.py:transcode_device feeds them to
the encoder.
"""
from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from theora_tpu_torch import resolve_device, transfer
from theora_tpu_torch.constants import (
    FRAME_GOLD, FRAME_PREV, FRAME_SELF, MVMAP, MVMAP2,
)
from theora_tpu_torch.decode.decoder import BadPacketError, Decoder
from theora_tpu_torch.decode.telemetry import render_telemetry
from theora_tpu_torch.info import INTER_FRAME, INTRA_FRAME
from theora_tpu_torch.native import dc_predict_native
from theora_tpu_torch.ops import idct_cuda, loopfilter_cuda, mc_cuda, \
    postproc_cuda

# Rows of the per-fragment int8 side array uploaded per plane and batch;
# rows _RS .. _U2 are KS's side rows (ops/mc.py:SIDE_ROWS).
_QII, _INTER, _RS, _Y1, _X1, _Y2, _X2, _U2, _CODED, _DONLY = range(10)


class BatchDecoder(Decoder):
    """Decode batches of packets with the pixel pipeline on `device`
    ("cuda" by default; "cpu" runs the plain PyTorch path). Reference
    planes stay resident on the device across batches."""

    def __init__(self, info, setup, device="cuda"):
        self.device = resolve_device(device)
        super().__init__(info, setup)
        g = self.geometry
        # Per-plane (prev, gold) padded uint8 planes, carried across
        # batches; None before the first decoded frame.
        self._refs: dict[int, tuple[torch.Tensor, torch.Tensor]] | None = None
        self._scan_by_plane = [g.scan_fragis[g.scan_pli == pli]
                               for pli in range(3)]
        # Host seconds spent parsing packets. A caller that sets
        # device_spans to a list gets a (start, end) CUDA event pair
        # around each batch's device work appended to it.
        self.host_parse_s = 0.0
        self.device_spans: list[tuple] | None = None
        # The last live frame's output planes on the device ({pli: [h, w]
        # uint8}, postprocessed where KP ran), and whether it was
        # postprocessed as of the host parse: a frame that codes no block
        # then repeats it, as the JAX decoder returns its last output for
        # such a frame (decode.c:2763-2772).
        self._last_out: dict[int, torch.Tensor] | None = None
        self._pp_shown = False
        self._pp_tables: tuple[torch.Tensor, torch.Tensor] | None = None

    # ------------------------------------------------------------------
    def _parse_batch(self, packets: list[bytes]) -> list[dict | None]:
        """Host side of a batch: side info, tokens and DC prediction per
        packet (None for a dup packet), and the postprocessor's and the
        overlays' per-frame state. Raises BadPacketError for a packet the
        parse rejects."""
        g = self.geometry
        per_frame = []
        for data in packets:
            if len(data) == 0:
                self.frame_type = INTER_FRAME
                self._update_granpos()
                per_frame.append(None)
                continue
            side = self._parse_sideinfo_native(data)
            coded = side["coded"]
            fragis = [f[coded[f]] for f in self._scan_by_plane]
            want_bits = bool(self.telemetry["bits"])
            try:
                qzc, lz, dcc, *rest = self._native.decode_frame_tokens(
                    data, side["bitpos"], [len(f) for f in fragis],
                    want_bits)
            except ValueError as e:
                raise BadPacketError(str(e)) from e
            self._update_granpos()
            order = np.concatenate(fragis)
            pp, repeat = None, False
            if coded.any():
                pp = self._pp_frame(side, self.qis,
                                    self.frame_type == INTRA_FRAME)
                self._pp_shown = pp is not None
                if any(self.telemetry.values()):
                    self._telemetry_state = {
                        "coded": coded, "mode": side["mode"],
                        "mv": side["mv"], "qii": side["qii"],
                        "order": order,
                        "frag_bits": rest[1] if want_bits else None}
            else:
                repeat = self._pp_shown
            last_zzi = np.full(g.nfrags, 64, dtype=np.int32)
            last_zzi[order] = lz
            dc_full = np.zeros(g.nfrags, dtype=np.int32)
            dc_full[order] = dcc
            for pli in range(3):
                pl = g.planes[pli]
                sl = slice(pl.froffset, pl.froffset + pl.nfrags)
                shape = (pl.nvfrags, pl.nhfrags)
                dc_pl = np.ascontiguousarray(dc_full[sl].reshape(shape))
                dc_predict_native(coded[sl].reshape(shape),
                                  side["refi"][sl].reshape(shape), dc_pl,
                                  [0, 0, 0])
                dc_full[sl] = dc_pl.reshape(-1)
            tele = None
            if any(self.telemetry.values()) and self._telemetry_state:
                tele = (dict(self.telemetry), self._telemetry_state)
            per_frame.append(
                dict(side=side, fragis=fragis, qz=qzc, last_zzi=last_zzi,
                     dc=dc_full, ftype=self.frame_type, qis=list(self.qis),
                     pp=pp, repeat=repeat, tele=tele)
            )
        return per_frame

    def _plane_inputs(self, live: list[dict], pli: int) -> dict:
        """Stack one plane's per-frame inputs over the live frames of a
        batch (host numpy)."""
        g = self.geometry
        pl = g.planes[pli]
        n = pl.nfrags
        sl = slice(pl.froffset, pl.froffset + n)
        qpx = 1 if (pli != 0 and not (self.info.pixel_fmt & 1)) else 0
        qpy = 1 if (pli != 0 and not (self.info.pixel_fmt & 2)) else 0
        F = len(live)
        # Postprocessing per frame: None, or (dering, strong) with the
        # frame's DC qis and qi per fragment in ppq[f] (pp levels 2-4
        # filter luma only, 5-7 all three planes).
        pp, ppq = [], np.zeros((F, 2, n), np.uint8)
        for fi, fr in enumerate(live):
            lvl = fr["pp"][2] if fr["pp"] is not None else 0
            if lvl < (5 if pli else 2):
                pp.append(None)
                continue
            ppq[fi, 0] = fr["pp"][0][sl]
            ppq[fi, 1] = fr["pp"][1][sl]
            pp.append((lvl >= (6 if pli else 3), lvl >= (7 if pli else 4)))
        counts = np.zeros((F, n), np.uint8)
        frag = np.zeros((F, 10, n), np.int8)
        deqt = np.zeros((F, 3, 2, 64), np.int16)
        dc = np.zeros((F, n), np.int16)
        zzs, vals, limits, intra = [], [], [], []
        for fi, fr in enumerate(live):
            side = fr["side"]
            # Nonzero AC coefficients of this plane's coded fragments, in
            # raster fragment order and ascending zig-zag order inside a
            # fragment (the order the device expands them).
            start = sum(len(f) for f in fr["fragis"][:pli])
            flat = fr["qz"][start:start + len(fr["fragis"][pli])].reshape(-1)
            idx = np.flatnonzero(flat)
            idx = idx[(idx & 63) != 0]
            rfrag = (fr["fragis"][pli] - pl.froffset)[idx >> 6]
            idx = idx[np.argsort(rfrag, kind="stable")]
            counts[fi] = np.bincount(rfrag, minlength=n)
            zzs.append((idx & 63).astype(np.uint8))
            vals.append(flat[idx])
            deqt[fi, : len(fr["qis"])] = self.dequant[fr["qis"], pli]
            refi = side["refi"][sl]
            rs = np.where(refi == FRAME_SELF, 0,
                          np.where(refi == FRAME_GOLD, 2, 1))
            dx = side["mv"][sl, 0] + 31
            dy = side["mv"][sl, 1] + 31
            mx, mx2 = MVMAP[qpx][dx], MVMAP2[qpx][dx]
            my, my2 = MVMAP[qpy][dy], MVMAP2[qpy][dy]
            coded = side["coded"][sl]
            frag[fi, _QII] = side["qii"][sl]
            frag[fi, _INTER] = refi != FRAME_SELF
            frag[fi, _RS] = rs
            frag[fi, _Y1] = my
            frag[fi, _X1] = mx
            frag[fi, _Y2] = my + my2
            frag[fi, _X2] = mx + mx2
            frag[fi, _U2] = ((mx2 != 0) | (my2 != 0)) & (rs != 0)
            frag[fi, _CODED] = coded
            frag[fi, _DONLY] = (fr["last_zzi"][sl] < 2) | ~coded
            dc[fi] = fr["dc"][sl]
            limits.append(
                int(self.setup.qinfo["loop_filter_limits"][fr["qis"][0]]))
            intra.append(fr["ftype"] == INTRA_FRAME)
        return dict(counts=counts, frag=frag, deqt=deqt, dc=dc,
                    zz=np.concatenate(zzs), vals=np.concatenate(vals),
                    limits=limits, intra=intra, pp=pp, ppq=ppq,
                    repeat=[fr["repeat"] for fr in live])

    def _initial_refs(self, pli: int):
        if self._refs is not None:
            return self._refs[pli]
        # Stream starts on an inter frame: gray references
        # (decode.c:2053-2080).
        pl = self.geometry.planes[pli]
        vpad, hpad = self.geometry.plane_padding(pli)
        gray = torch.full(
            (pl.nvfrags * 8 + 2 * vpad, pl.nhfrags * 8 + 2 * hpad), 0x80,
            dtype=torch.uint8, device=self.device,
        )
        return gray, gray

    def _decode_plane(self, inp: dict, pli: int):
        """Device work for one plane of a batch. Returns ([F, h, w] uint8
        frames without padding, final prev plane, final gold plane)."""
        g = self.geometry
        dev = self.device
        pl = g.planes[pli]
        nv, nh, n = pl.nvfrags, pl.nhfrags, pl.nfrags
        vpad, hpad = g.plane_padding(pli)
        h, w = g.plane_shape(pli)
        F = inp["frag"].shape[0]
        # record_function labels group profiler time by codec stage
        # (tools/profile_decode.py).
        with record_function("theora.upload"):
            frag = transfer.upload(inp["frag"], dev)
            nnz = len(inp["zz"])
            counts = transfer.upload(inp["counts"], dev).reshape(-1)
            zz = transfer.upload(inp["zz"], dev)
            vals = transfer.upload(inp["vals"], dev)
            # Sparse -> dense [F*n, 64] zig-zag coefficients.
            ids = torch.arange(F * n, device=dev).repeat_interleave(
                counts.long(), output_size=nnz)
            qz = torch.zeros((F * n, 64), dtype=torch.int16, device=dev)
            qz[ids, zz.long()] = vals
            k1_args = (
                qz,
                transfer.upload(inp["dc"], dev).reshape(-1),
                transfer.upload(inp["deqt"], dev),
                torch.arange(F, dtype=torch.int32, device=dev)
                .repeat_interleave(n),
                frag[:, _QII].reshape(-1).to(torch.uint8),
                frag[:, _INTER].reshape(-1).to(torch.uint8),
                frag[:, _DONLY].reshape(-1).bool(),
            )
        with record_function("theora.dequant_idct"):
            residual = idct_cuda.dequantize_idct_frames(*k1_args)
        residual = residual.reshape(F, n, 64)

        if any(p is not None for p in inp["pp"]):
            with record_function("theora.upload"):
                ppq = transfer.upload(inp["ppq"], dev).reshape(F, 2, nv, nh)
            dc_scale, sharp = self._pp_device_tables()

        prev, gold = self._initial_refs(pli)
        out = torch.empty((F, h, w), dtype=torch.uint8, device=dev)
        for f in range(F):
            fs = frag[f]
            pp, repeat = inp["pp"][f], inp["repeat"][f]
            # KL fills the borders and the output of the planes it
            # filters; KS those of the others. KP writes the output of a
            # postprocessed plane; a frame that codes no block repeats the
            # last output when that was postprocessed.
            filtered = bool(inp["limits"][f])
            direct = pp is None and not repeat
            with record_function("theora.mc_recon"):
                plane = mc_cuda.mc_recon(
                    prev, gold, residual[f], fs[_RS:_U2 + 1], nv, nh, vpad,
                    hpad, borders=not filtered,
                    pic=out[f] if direct and not filtered else None)
            if filtered:
                with record_function("theora.loopfilter"):
                    plane = loopfilter_cuda.loop_filter_plane(
                        plane, fs[_CODED].bool().reshape(nv, nh),
                        inp["limits"][f], nv, nh, vpad, hpad,
                    )
                if direct:
                    with record_function("theora.borders"):
                        out[f] = plane[vpad:vpad + h, hpad:hpad + w]
            if repeat:
                out[f] = out[f - 1] if f else self._last_out[pli]
            elif pp is not None:
                with record_function("theora.postproc"):
                    postproc_cuda.postprocess_plane(
                        plane[vpad:vpad + h, hpad:hpad + w], ppq[f, 0],
                        ppq[f, 1], dc_scale, sharp, pp[0], pp[1], pli,
                        out=out[f])
            if inp["intra"][f]:
                gold = plane
            prev = plane
        return out, prev, gold

    def _pp_device_tables(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The postprocessor's [64] int32 DC scale and sharpening tables on
        the device, uploaded once."""
        if self._pp_tables is None:
            self._pp_tables = tuple(
                torch.from_numpy(np.ascontiguousarray(t, np.int32)).to(
                    self.device) for t in (self._pp_dc_scale,
                                           self._pp_sharp_mod))
        return self._pp_tables

    def dispatch_batch(self, packets: list[bytes]):
        """Parse a batch on the host and enqueue its device work without
        downloading pixels. Returns None when the batch holds no live
        frame (all dups), else {"dev": {pli: [F_live, h, w] uint8 device
        planes, bitstream orientation, no padding}, "emit": per-packet
        index into the live axis, -1 for a dup before the first live
        frame}."""
        t0 = time.perf_counter()
        per_frame = self._parse_batch(packets)
        self.host_parse_s += time.perf_counter() - t0
        live = [f for f in per_frame if f is not None]
        if not live:
            return None
        emit = []
        li = -1
        for fr in per_frame:
            if fr is not None:
                li += 1
            emit.append(li)
        return {"dev": self._dispatch_live(live), "emit": emit,
                "tele": [fr["tele"] for fr in live]}

    def _dispatch_live(self, live: list[dict]) -> dict:
        """Enqueue the device work of parsed live frames, carry the
        reference planes and slots on; returns {pli: [F, h, w] uint8}
        device planes."""
        t0 = time.perf_counter()
        inputs = [self._plane_inputs(live, pli) for pli in range(3)]
        self.host_parse_s += time.perf_counter() - t0

        span = None
        if self.device.type == "cuda" and self.device_spans is not None:
            span = (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
            span[0].record()
        out_planes, refs = {}, {}
        for pli in range(3):
            out, prev, gold = self._decode_plane(inputs[pli], pli)
            out_planes[pli] = out
            refs[pli] = (prev, gold)
        self._refs = refs
        self._last_out = {pli: out_planes[pli][-1] for pli in range(3)}
        if span is not None:
            span[1].record()
            self.device_spans.append(span)

        # Reference slot bookkeeping, as the JAX batch decoder keeps it.
        last_intra = None
        for i, fr in enumerate(live):
            if fr["ftype"] == INTRA_FRAME:
                last_intra = i
        refi = 0
        while refi in (self.ref_idx[FRAME_GOLD], self.ref_idx[FRAME_PREV]):
            refi += 1
        self.ref_idx[FRAME_PREV] = refi
        self.ref_idx[FRAME_SELF] = refi
        if last_intra is not None:
            self.ref_idx[FRAME_GOLD] = (
                refi if last_intra == len(live) - 1 else int(refi == 0)
            )
        return out_planes

    # ------------------------------------------------------------------
    @staticmethod
    def _start_download(dev_planes: dict) -> transfer.Download:
        """Begin the device->host copies of a batch's planes."""
        return transfer.Download([dev_planes[pli] for pli in range(3)])

    def _frame(self, host: list, li: int, st: dict) -> list[np.ndarray]:
        """Display-orientation [y, u, v] of live frame li, with the
        overlays that were on when it was parsed."""
        frame = [host[pli][li][::-1].copy() for pli in range(3)]
        if st["tele"][li] is not None:
            flags, state = st["tele"][li]
            render_telemetry(self.geometry, frame, state, **flags)
        return frame

    def _prev_output_frame(self) -> list[np.ndarray]:
        """The most recent output frame, display orientation, without
        overlays: the last live frame's output (postprocessed where KP
        ran), or the PREV reference's image when the references were
        loaded (decode/state.py) or made gray; for a batch that begins
        with dup packets."""
        if self._refs is None:
            raise ValueError("stream must start with a live frame")
        g = self.geometry
        frame = []
        for pli in range(3):
            if self._last_out is not None:
                p = self._last_out[pli]
            else:
                vpad, hpad = g.plane_padding(pli)
                h, w = g.plane_shape(pli)
                p = self._refs[pli][0][vpad:vpad + h, hpad:hpad + w]
            frame.append(p.cpu().numpy()[::-1].copy())
        return frame

    def _output_frame(self) -> list[np.ndarray]:
        """The most recent output frame as the JAX decoder's ycbcr_out
        gives it: display orientation, the overlays that are on drawn
        with the last state recorded while any was on."""
        frame = self._prev_output_frame()
        if any(self.telemetry.values()) and self._telemetry_state:
            render_telemetry(self.geometry, frame, self._telemetry_state,
                             **self.telemetry)
        return frame

    def _no_callback(self, what: str) -> None:
        if self.stripe_callback is not None:
            raise ValueError(f"{what} does not fire the stripe callback; "
                             f"decode with PacketDecoder.decode_packet")

    def decode_batch(self, packets: list[bytes]) -> list[list[np.ndarray]]:
        """Display-orientation [y, u, v] planes per packet. The batch must
        start at a decodable point (keyframe or existing reference
        state); dup packets repeat the previous output. Raises ValueError
        when a stripe callback is set."""
        self._no_callback("decode_batch")
        prev_frame = None
        if packets and len(packets[0]) == 0:
            prev_frame = self._output_frame()
        st = self.dispatch_batch(packets)
        if st is None:
            if prev_frame is None:
                prev_frame = self._output_frame()
            return [[p.copy() for p in prev_frame] for _ in packets]
        host = self._start_download(st["dev"]).wait()
        return [
            [p.copy() for p in prev_frame] if li < 0
            else self._frame(host, li, st)
            for li in st["emit"]
        ]

    def decode_clip(self, packets: list[bytes], batch: int = 8,
                    ) -> list[list[np.ndarray]]:
        """Decode a clip in batches dispatched two deep: each batch's
        device->host copies start as soon as its work is enqueued, and
        are waited for only after the next batch has been parsed and
        enqueued, so the copies of batch k overlap the host parse and
        device work of batch k+1. Returns display-orientation [y, u, v]
        planes per packet. Raises ValueError when a stripe callback is
        set."""
        self._no_callback("decode_clip")
        chunks = [packets[i:i + batch] for i in range(0, len(packets), batch)]
        outs: list = []
        # A clip that leads with a dup repeats a frame from before this
        # call.
        prior_frame = None
        if packets and len(packets[0]) == 0:
            prior_frame = self._output_frame()

        def last_frame():
            prev = outs[-1] if outs else prior_frame
            if prev is None:
                raise ValueError("stream must start with a live frame")
            return [f.copy() for f in prev]

        def drain(item):
            chunk, st, download = item
            if st is None:
                outs.extend(last_frame() for _ in chunk)
                return
            host = download.wait()
            for li in st["emit"]:
                # A dup before the chunk's first live frame repeats the
                # previous chunk's last output, not a future frame.
                outs.append(last_frame() if li < 0
                            else self._frame(host, li, st))

        pending = None
        for chunk in chunks + [None]:
            item = None
            if chunk is not None:
                st = self.dispatch_batch(chunk)
                download = None if st is None else self._start_download(
                    st["dev"])
                item = (chunk, st, download)
            if pending is not None:
                drain(pending)
            pending = item
        return outs

    def reference_planes(self):
        """The resident reference planes as numpy: (prev_planes,
        gold_planes), each a list of three padded uint8 planes in
        bitstream orientation (the role of TpuBatchDecoder's
        sync_refs_to_host)."""
        if self._refs is None:
            raise ValueError("no reference state yet")
        prev = [self._refs[pli][0].cpu().numpy() for pli in range(3)]
        gold = [self._refs[pli][1].cpu().numpy() for pli in range(3)]
        return prev, gold
