"""All-keyframe batch encoder on the card.

Port of theora_tpu/encode/tpu_encoder.py (`TpuBatchIntraEncoder`). The
planes of a batch go up to the device (transfer.upload), where the blocks
are cut and their residuals against 128 formed as int16; kernel K2
(ops/fdct_cuda.py) computes the fDCT and round-to-nearest quantization of
every block of every frame of the batch in one launch per plane index,
and the (DCT, quantized) pairs come down in one transfer.Download. The
host then runs the bit-serial stages frame by frame (trellis planning, DC
prediction, token packing) through the keyframe path of the host Encoder
(encode/encoder.py), which takes the device's results. The packets are
byte-identical to the host Encoder's at keyframe_freq=1.

Which frames take the device's results follows the JAX Encoder
(encoder.py:553-566): a frame whose qi list holds more than one qi
(adaptive quantization's triple) runs the host's multi-qi trellis, and at
speed levels 2 and more every frame runs the host's quantizers. Their qi
lists depend on the source alone, so they are decided before the launch
and such frames are left out of it.

Fault F5 of the reference, not copied: the JAX batch reads the encoder's
qi once per batch and quantizes every frame with it, while the host
Encoder moves qi through rate control frame by frame, so with a target
bitrate its packets differ from the host's (ROADMAP section 3). Here,
with target_bitrate > 0 a frame's qi is known only after the previous
frame's rate-control update, so K2 is launched for each frame, at the qi
rate control selected for it.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from theora_tpu_torch import resolve_device, transfer
from theora_tpu_torch.encode.encoder import Encoder
from theora_tpu_torch.info import TheoraInfo
from theora_tpu_torch.ops import fdct_cuda
from theora_tpu_torch.tpkt import Packet


class BatchIntraEncoder:
    """Encode batches of frames as keyframes, with the fDCT and
    quantization on `device` ("cuda" unless the caller asks for "cpu").

    After each encode, `timing` holds the seconds of the frames'
    adaptive-quantization gates on the host ("gates_s"), of the device
    work (upload, K2, download; "device_s") and of each frame's host
    stages ("host_s")."""

    def __init__(self, info: TheoraInfo, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.info = info
        self.enc = Encoder(info, device=self.device)
        self.enc.keyframe_freq = 1
        self.timing = {}

    def flush_headers(self) -> list[Packet]:
        return self.enc.flush_headers()

    def _residuals(self, frames) -> list:
        """Per plane, [B, N, 64] int16 residuals of the batch's blocks
        (raster order, bitstream orientation) on the device."""
        g = self.enc.geometry
        keep = []
        out = []
        for pli in range(3):
            pl = g.planes[pli]
            h, w = pl.nvfrags * 8, pl.nhfrags * 8
            host = np.stack([fr[pli][::-1][:h, :w] for fr in frames])
            planes = transfer.upload(host, self.device, keep)
            blocks = planes.reshape(len(frames), pl.nvfrags, 8, pl.nhfrags,
                                    8).permute(0, 1, 3, 2, 4).reshape(
                                        len(frames), pl.nfrags, 64)
            out.append(blocks.to(torch.int16) - 128)
        return out

    def _fdct_quant(self, res, take, qi) -> list:
        """K2 at qi over the blocks of the frames `take` (indices into
        res's batch), one launch per plane; one download. Returns, per
        frame of take, {pli: (dct16, qdct)} as [n, 64] int16 numpy
        arrays."""
        dev = self.device
        outs = []
        for pli in range(3):
            r = res[pli] if len(take) == res[pli].shape[0] else \
                res[pli][torch.as_tensor(take, device=dev)]
            deq = torch.from_numpy(np.ascontiguousarray(np.broadcast_to(
                self.enc.dequant[qi, pli, 0].astype(np.int16), (1, 2, 64))))
            qout, dout = fdct_cuda.fdct_quantize(
                r.reshape(-1, 64), deq.to(dev),
                torch.zeros(r.shape[0] * r.shape[1], dtype=torch.uint8,
                            device=dev))
            outs += [dout, qout[0]]
        host = transfer.Download(outs).wait()
        return [{pli: tuple(a.reshape(len(take), -1, 64)[j]
                            for a in host[2 * pli:2 * pli + 2])
                 for pli in range(3)} for j in range(len(take))]

    def encode(self, frames: list) -> list[Packet]:
        """frames: list of [y, u, v] display-orientation planes. Returns
        one keyframe packet per frame, byte-identical to the host Encoder
        at keyframe_freq=1."""
        t0 = time.perf_counter()
        enc = self.enc
        gates = [enc.frame_gates(fr) for fr in frames]
        self.timing = {"gates_s": time.perf_counter() - t0, "device_s": 0.0,
                       "host_s": []}
        if not frames:
            return []
        t0 = time.perf_counter()
        if self.info.target_bitrate > 0:
            # F5: each frame at the qi rate control selects for it; the
            # encoder asks only where the frame takes the results.
            res = self._residuals(frames)

            def source(fi):
                def tq(planes, qi):
                    t = time.perf_counter()
                    out = self._fdct_quant(res, [fi], qi)[0]
                    self.timing["device_s"] += time.perf_counter() - t
                    return out
                return tq
            sources = [source(fi) for fi in range(len(frames))]
        else:
            take = [fi for fi, gt in enumerate(gates)
                    if enc.uses_device_tq(enc.keyframe_qis(gt))]
            sources = [None] * len(frames)
            if take:
                res = self._residuals([frames[fi] for fi in take])
                pre = self._fdct_quant(res, range(len(take)), enc.qi)
                for fi, p in zip(take, pre):
                    sources[fi] = (lambda planes, qi, p=p: p)
        self.timing["device_s"] += time.perf_counter() - t0
        pkts = []
        try:
            for fi, fr in enumerate(frames):
                enc.device_tq = sources[fi]
                dev0 = self.timing["device_s"]
                t0 = time.perf_counter()
                pkts.append(enc.encode_frame(fr, gates=gates[fi]))
                self.timing["host_s"].append(
                    time.perf_counter() - t0
                    - (self.timing["device_s"] - dev0))
        finally:
            enc.device_tq = None
        return pkts
