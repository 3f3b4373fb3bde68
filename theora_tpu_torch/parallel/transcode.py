"""GOP-parallel transcode: split a clip at keyframe boundaries, encode the
GOPs independently and in parallel, and gather the packets in stream
order.

Port of theora_tpu/parallel/transcode.py (`split_gops`, `_encode_gop`,
`transcode`, the fault injection). Each GOP runs through its own host
Encoder (encode/encoder.py), whose closed loop decodes on `device`: the
coding state is GOP-local (the trellis cost model resets at each
keyframe, the golden frame is the keyframe), so the output is
byte-identical to one sequential Encoder at the same keyframe spacing.

Workers are threads (they share the card; the native calls release the
GIL) or, with use_processes, processes started with the "spawn" method:
a process forked after CUDA or PyTorch's thread pool has started can
hang. Each process builds its Encoder on `device`. A worker that dies
loses only its own GOPs: they go to a fresh pool, up to three rounds,
and whatever is still pending is encoded inline. CBR is refused: each
GOP would run its own rate reservoir.
"""
from __future__ import annotations

import concurrent.futures as cf
import multiprocessing
import os
import signal

import torch

from theora_tpu_torch.encode.encoder import Encoder
from theora_tpu_torch.encode.packer import FramePacker
from theora_tpu_torch.info import TheoraInfo
from theora_tpu_torch.tpkt import Packet

# Fault injection for the elastic-retry tests: "<gop_index>:<marker_path>".
# The first worker to encode that GOP creates the marker and SIGKILLs
# itself; retries see the marker and go on.
_FAULT_ENV = "THEORA_TPU_FAULT_KILL_GOP"


def _maybe_inject_fault(gop_index: int) -> None:
    spec = os.environ.get(_FAULT_ENV)
    if not spec:
        return
    tgt, marker = spec.split(":", 1)
    if int(tgt) == gop_index and not os.path.exists(marker):
        with open(marker, "w"):
            pass
        os.kill(os.getpid(), signal.SIGKILL)


def split_gops(frames: list, keyframe_freq: int) -> list[list]:
    return [frames[i:i + keyframe_freq]
            for i in range(0, len(frames), keyframe_freq)]


def _encode_gop(info: TheoraInfo, gop_frames, frame_base: int,
                keyframe_freq: int, is_last: bool, rd_strength,
                device) -> list[Packet]:
    """The packets of one GOP, frame numbers from frame_base on."""
    _maybe_inject_fault(frame_base // max(keyframe_freq, 1))
    enc = Encoder(info, device=device)
    enc.keyframe_freq = keyframe_freq
    enc.curframe_num = frame_base - 1
    if rd_strength is not None:
        enc.rd_strength = rd_strength
    return [enc.encode_frame(fr, e_o_s=is_last and j == len(gop_frames) - 1)
            for j, fr in enumerate(gop_frames)]


def transcode(frames: list, info: TheoraInfo, keyframe_freq: int = 64,
              max_workers: int | None = None,
              rd_strength: float | None = None, use_processes: bool = False,
              device: str | torch.device = "cuda") -> list[Packet]:
    """Encode a clip GOP-parallel on `device`; returns the header and data
    packets in stream order with their granule positions and packet
    numbers."""
    if info.target_bitrate > 0:
        raise ValueError(
            "GOP-parallel transcode does not support CBR "
            "(target_bitrate > 0): per-GOP reservoirs would break "
            "sequential byte-identity; encode sequentially instead")
    header_pkts = FramePacker(info).flush_headers()
    gops = split_gops(frames, keyframe_freq)
    results: list = [None] * len(gops)
    if use_processes:
        ctx = multiprocessing.get_context("spawn")

        def pool():
            return cf.ProcessPoolExecutor(max_workers=max_workers,
                                          mp_context=ctx)
    else:
        def pool():
            return cf.ThreadPoolExecutor(max_workers=max_workers)

    def args(gi):
        return (info, gops[gi], gi * keyframe_freq, keyframe_freq,
                gi == len(gops) - 1, rd_strength, device)

    # Elastic retry: a killed or crashed worker loses only its own GOPs,
    # which go to a fresh pool; GOP outputs are deterministic.
    pending = set(range(len(gops)))
    for _ in range(3):
        if not pending:
            break
        broken = False
        with pool() as ex:
            futs = {ex.submit(_encode_gop, *args(gi)): gi for gi in pending}
            for fut in cf.as_completed(futs):
                gi = futs[fut]
                try:
                    results[gi] = fut.result()
                    pending.discard(gi)
                except Exception:
                    # A dead process poisons every outstanding future; keep
                    # the GOP pending and rebuild the pool.
                    broken = True
        if pending and not broken:
            break  # a persistent per-GOP failure: do not spin
    # Last resort: the stragglers inline, so a flaky pool loses no output.
    for gi in sorted(pending):
        results[gi] = _encode_gop(*args(gi))
    out = list(header_pkts)
    for pkts in results:
        for p in pkts:
            p.packetno = len(out)
            out.append(p)
    return out
