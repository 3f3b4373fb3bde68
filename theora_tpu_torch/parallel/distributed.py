"""GOP-parallel transcode over torch.distributed processes.

Port of theora_tpu/parallel/distributed.py (`_pack_blob`, `_unpack_blob`,
`distributed_transcode`). GOPs are independent coding units, so each
process encodes a round-robin share of them (parallel/transcode.py:
_encode_gop, the host Encoder with its closed loop on `device`) and
process 0 gathers the packed bytes in stream order. The only
communication is that ordered gather: JAX's
`multihost_utils.process_allgather` (distributed.py:120-137) becomes two
`torch.distributed.all_gather` calls over CPU tensors, the GOPs' blob
lengths and then the blobs padded to the longest, each reduced by the
elementwise maximum over the processes. The process group must gather CPU
tensors (the "gloo" backend). Where no group is initialised the world is
one process, as JAX's is without jax.distributed.

Usage (per process):
    torch.distributed.init_process_group(
        "gloo", init_method="tcp://localhost:<port>", world_size=N,
        rank=r)
    pkts = distributed_transcode(frames, info, keyframe_freq=...,
                                 device="cuda")
    # pkts is the ordered packet list on rank 0, [] elsewhere.

JAX's reserved `configure` argument (a no-op statement there,
distributed.py:115-116) is not taken. Fault of the reference not copied:
JAX does not check gop_bases (distributed.py:88-99); here it must be
strictly ascending, start at 0 and end below len(frames).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from theora_tpu_torch.encode.packer import FramePacker
from theora_tpu_torch.info import TheoraInfo
from theora_tpu_torch.parallel.transcode import _encode_gop, split_gops
from theora_tpu_torch.tpkt import Packet


def _pack_blob(pkts: list[Packet]) -> bytes:
    """A GOP's packets as length-prefixed data with granulepos and
    e_o_s."""
    out = bytearray()
    for p in pkts:
        out += len(p.data).to_bytes(4, "little")
        out += int(p.granulepos).to_bytes(8, "little", signed=True)
        out += bytes([1 if p.e_o_s else 0])
        out += p.data
    return bytes(out)


def _unpack_blob(blob: bytes, packetno0: int) -> list[Packet]:
    pkts = []
    off = 0
    while off < len(blob):
        n = int.from_bytes(blob[off:off + 4], "little")
        gp = int.from_bytes(blob[off + 4:off + 12], "little", signed=True)
        eos = blob[off + 12] == 1
        off += 13
        pkts.append(Packet(blob[off:off + n], granulepos=gp,
                           packetno=packetno0 + len(pkts), e_o_s=eos))
        off += n
    return pkts


def _allgather_max(t: torch.Tensor) -> torch.Tensor:
    """The elementwise maximum of a CPU tensor over the processes."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return t
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t)
    return torch.stack(parts).amax(dim=0)


def distributed_transcode(frames: list, info: TheoraInfo,
                          keyframe_freq: int = 64,
                          _drop_gops: set | None = None,
                          gop_bases: list | None = None,
                          device: str | torch.device = "cuda"):
    """Encode `frames` across the processes of the torch.distributed
    group, each on `device`; returns the ordered packet list (headers
    included) on rank 0, [] elsewhere. Every process passes the same
    frames, info and GOP split; only its own GOPs are encoded.

    gop_bases: an uneven GOP split (strictly ascending frame indices from
    0, e.g. scene cuts), the same on every process; each GOP then has one
    keyframe, at its start. None cuts every keyframe_freq frames.
    _drop_gops: GOPs this process loses after their assignment (fault
    injection); rank 0 re-encodes every GOP that nobody reports."""
    if info.target_bitrate > 0:
        raise ValueError(
            "distributed transcode does not support CBR "
            "(target_bitrate > 0); encode sequentially instead")
    nproc = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if gop_bases is not None:
        bases = [int(b) for b in gop_bases]
        if (not bases or bases[0] != 0 or bases[-1] >= len(frames)
                or any(a >= b for a, b in zip(bases, bases[1:]))):
            raise ValueError(
                f"gop_bases must be strictly ascending, start at 0 and end "
                f"below len(frames) = {len(frames)}; got {list(gop_bases)}")
        ends = bases[1:] + [len(frames)]
        gops = [frames[a:b] for a, b in zip(bases, ends)]
        gop_base = bases
        # Each GOP's keyframe_freq is its length: only its first frame is
        # a forced keyframe.
        gop_kf = [len(g) for g in gops]
    else:
        gops = split_gops(frames, keyframe_freq)
        gop_base = [gi * keyframe_freq for gi in range(len(gops))]
        gop_kf = [keyframe_freq] * len(gops)
    ngops = len(gops)

    def encode(gi):
        return _pack_blob(_encode_gop(info, gops[gi], gop_base[gi],
                                      gop_kf[gi], gi == ngops - 1, None,
                                      device))

    blobs = {gi: encode(gi) for gi in range(rank, ngops, nproc)
             if not (_drop_gops and gi in _drop_gops)}
    # The ordered gather: the lengths first, then one row per GOP padded
    # to the longest blob; a GOP is nonzero on one process at most.
    lengths = torch.zeros(ngops, dtype=torch.int64)
    for gi, b in blobs.items():
        lengths[gi] = len(b)
    full_lengths = _allgather_max(lengths).numpy().copy()
    maxlen = int(full_lengths.max()) if ngops else 0
    local = np.zeros((ngops, max(maxlen, 1)), dtype=np.uint8)
    for gi, b in blobs.items():
        local[gi, :len(b)] = np.frombuffer(b, dtype=np.uint8)
    gathered = _allgather_max(torch.from_numpy(local)).numpy()
    if rank != 0:
        return []
    # Elastic recovery: a GOP that no process reported was lost by its
    # owner after the assignment; rank 0 encodes it, and the output is
    # byte-identical to what the owner would have sent.
    rows = {gi: gathered[gi, :int(full_lengths[gi])].tobytes()
            for gi in range(ngops)}
    for gi in range(ngops):
        if full_lengths[gi] == 0:
            rows[gi] = encode(gi)
    pkts = FramePacker(info).flush_headers()
    for gi in range(ngops):
        pkts.extend(_unpack_blob(rows[gi], len(pkts)))
    return pkts
