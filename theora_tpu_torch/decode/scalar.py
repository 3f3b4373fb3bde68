"""Per-packet decode on the card.

Port of theora_tpu/decode/tpu_decoder.py (`TpuDecoder`: `decode_packet`
and `ycbcr_out`). It is built on BatchDecoder's device state: a packet
is a batch of one, through the same host parse and kernel K1's decode
entry, and the reference planes stay resident on the card. Decoding by
batch (decode_batch, decode_clip, dispatch_batch) and by packet can
therefore alternate on one stream with nothing copied between them. The
JAX package's scalar and batch decoders keep separate references and
hand them over through the host (TpuBatchDecoder.sync_refs_to_host,
tpu_batch.py:504); here reference_planes() serves that role, for a
caller that wants the references on the host.
"""
from __future__ import annotations

import time

import numpy as np

from theora_tpu_torch.decode.batch import BatchDecoder
from theora_tpu_torch.info import INTRA_FRAME


class PacketDecoder(BatchDecoder):
    """Decode a stream packet by packet with the pixel pipeline on
    `device` ("cuda" by default; "cpu" runs the plain PyTorch path)."""

    def decode_packet(self, packet: bytes) -> int:
        """Decode one data packet. Returns 0 on a new frame, 1 for a dup
        (0-byte) packet or a frame that codes no block, whose output
        repeats the previous frame (decode.c:2763-2772). granpos follows
        the JAX decoders'. The device work is queued; ycbcr_out waits
        for it."""
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
        return 0

    def ycbcr_out(self) -> list[np.ndarray]:
        """[y, u, v] of the latest output frame: display orientation,
        frame size, without the UMV padding. Waits for its decode."""
        return self._prev_output_frame()
