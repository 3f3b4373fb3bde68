"""Per-packet decode on the card.

Port of theora_tpu/decode/tpu_decoder.py (`TpuDecoder`: `decode_packet`
and `ycbcr_out`) and of the host decoder's controls around them
(theora_tpu/decode/decoder.py: the postprocessor, the telemetry overlays
and the striped-decode callback). It is built on BatchDecoder's device
state: a packet is a batch of one, through the same host parse and
kernels (K1's decode entry, KS's `mc_recon`, KL, and KP where a pp level
is set), and the reference planes stay resident on the card. Decoding by
batch (decode_batch, decode_clip, dispatch_batch) and by packet can
therefore alternate on one stream with nothing copied between them, the
postprocessor's state included. The JAX package's scalar and batch
decoders keep separate references and hand them over through the host
(TpuBatchDecoder.sync_refs_to_host, tpu_batch.py:504); here
reference_planes() serves that role, for a caller that wants the
references on the host.
"""
from __future__ import annotations

import time

import numpy as np

from theora_tpu_torch.decode.batch import BatchDecoder
from theora_tpu_torch.info import INTRA_FRAME


def stripe_rows(nvy: int, nvc: int, shift: int, filters: bool):
    """The (yfrag0, yfrag_end) pairs of the striped-decode callback for a
    frame of nvy luma fragment rows and nvc chroma ones, chroma shifted
    vertically by shift, whose loop filter runs (filters) or not: luma
    fragment rows of the display-oriented frame, bottom to top, as the
    JAX decoder fires them (theora_tpu/decode/decoder.py:1057-1108; a
    filtered row is final one row behind the filter, decode.c:2858-2943).
    """
    nvf = (nvy, nvc, nvc)
    sh = (0, shift, shift)
    out = []
    delivered = 0
    for y1 in range(4, nvy + 4, 4):
        y1 = min(y1, nvy)
        avail = nvy
        for pli in range(3):
            r1 = min(y1 >> sh[pli], nvf[pli])
            edelay = 1 if filters and r1 < nvf[pli] else 0
            avail = min(avail, (r1 - edelay) << sh[pli])
        if avail > delivered:
            out.append((nvy - avail, nvy - delivered))
            delivered = avail
    return out


class PacketDecoder(BatchDecoder):
    """Decode a stream packet by packet with the pixel pipeline on
    `device` ("cuda" by default; "cpu" runs the plain PyTorch path)."""

    def decode_packet(self, packet: bytes) -> int:
        """Decode one data packet. Returns 0 on a new frame, 1 for a dup
        (0-byte) packet or a frame that codes no block, whose output
        repeats the previous frame (decode.c:2763-2772). granpos follows
        the JAX decoders'. The device work is queued; ycbcr_out waits
        for it. With a stripe callback set, the frame is finished first
        and the callback then gets the final rows in the JAX decoder's
        stripes: those of the striped loop filter when no pp level and
        no overlay is set, else four fragment rows at a time."""
        t0 = time.perf_counter()
        fr = self._parse_batch([packet])[0]
        self.host_parse_s += time.perf_counter() - t0
        if fr is not None and fr["ftype"] != INTRA_FRAME \
                and self._refs is None:
            # A stream that starts on an inter frame predicts from gray
            # references (decode.c:2053-2080).
            self._refs = {pli: self._initial_refs(pli) for pli in range(3)}
        if fr is None or not fr["side"]["coded"].any():
            return 1
        self._dispatch_live([fr])
        if self.stripe_callback is not None:
            self._fire_stripes(fr)
        return 0

    def _fire_stripes(self, fr: dict) -> None:
        g = self.geometry
        nvy = g.planes[0].nvfrags
        if self.pp_level == 0 and not any(self.telemetry.values()):
            nvc = g.planes[1].nvfrags
            limit = self.setup.qinfo["loop_filter_limits"][fr["qis"][0]]
            pairs = stripe_rows(nvy, nvc, 1 if nvc < nvy else 0, limit > 0)
        else:
            pairs = [(max(a - 4, 0), a) for a in range(nvy, 0, -4)]
        ycbcr = self.ycbcr_out()
        for y0, y1 in pairs:
            self.stripe_callback(ycbcr, y0, y1)

    def ycbcr_out(self) -> list[np.ndarray]:
        """[y, u, v] of the latest output frame: display orientation,
        frame size, without the UMV padding, postprocessed where a pp
        level was set, with the overlays that are on. Waits for its
        decode."""
        return self._output_frame()
