"""A mesh over torch.distributed ranks, one rank per device.

JAX lays its (gop, frag) mesh over the devices of one controller
(theora_tpu/parallel/gop.py:41-50) and moves data between them with
collectives inside shard_map. The port runs one process per device
instead: rank r of a world of W sits at gop index r // frag_axis and frag
index r % frag_axis. The ranks that share a gop index form a frag group,
which splits each frame's fragments between them and all-gathers the
reconstructed blocks and coded flags at every frame step (JAX's
`all_gather` over "frag", encode/tpu_gop.py:294-309); the W // frag_axis
groups each encode their share of a batch's GOPs. The rate collective is
an all-reduce over every rank.

The process group is the caller's: the mesh needs only that it can
all-gather, gather and all-reduce the tensors it is given. A group whose
backend is NCCL takes the card's tensors as they are (route "device").
Any other backend (gloo: the CPU, and several ranks on one card) is given
CPU tensors: a card's tensor is copied into a pinned host buffer, the
collective runs there, and the result is copied back to the card (route
"pinned host"). The compute stays on the card either way. On the CPU the
route is "cpu".
"""
from __future__ import annotations

import pickle
import time

import numpy as np
import torch
import torch.distributed as dist


class _Collective:
    """A process group and the route its collectives take; per kind of
    call, the calls, the host seconds they took and the bytes each rank
    gave (`stats`)."""

    def __init__(self, group, ranks: list[int], device: torch.device):
        self.group = group
        self.ranks = ranks
        self.size = len(ranks)
        self.device = device
        # How the collectives move `device`'s tensors.
        self.route = "cpu" if device.type != "cuda" else (
            "device" if dist.get_backend(group) == "nccl" else "pinned host")
        self.stats: dict[str, list] = {}

    def _to_wire(self, t: torch.Tensor) -> torch.Tensor:
        """t as the backend takes it. On the pinned-host route a card's
        tensor is copied to the host after the stream's queued work, which
        is waited for first and left out of the collective's time."""
        if t.device.type != "cuda" or self.route == "device":
            return t.contiguous()
        torch.cuda.current_stream(t.device).synchronize()
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        return host

    def _empty(self, wire: torch.Tensor) -> torch.Tensor:
        return torch.empty((self.size, *wire.shape), dtype=wire.dtype,
                           device=wire.device,
                           pin_memory=wire.device != self.device
                           and wire.device.type == "cpu")

    @staticmethod
    def _from_wire(out: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        return out if out.device == t.device else out.to(
            t.device, non_blocking=True)

    def _count(self, kind: str, t0: float, nbytes: int) -> None:
        s = self.stats.setdefault(kind, [0, 0.0, 0])
        s[0] += 1
        s[1] += time.perf_counter() - t0
        s[2] += nbytes

    def all_gather(self, t: torch.Tensor, kind: str = "all_gather"):
        """[size, *t.shape]: every rank's t, in rank order, on every
        rank."""
        wire = self._to_wire(t)
        t0 = time.perf_counter()
        out = self._empty(wire)
        dist.all_gather(list(out.unbind(0)), wire, group=self.group)
        out = self._from_wire(out, t)
        self._count(kind, t0, t.numel() * t.element_size())
        return out

    def gather_first(self, t: torch.Tensor, kind: str = "gather"):
        """[size, *t.shape] on the group's first rank, in rank order; None
        on the others."""
        wire = self._to_wire(t)
        t0 = time.perf_counter()
        first = dist.get_rank() == self.ranks[0]
        out = self._empty(wire) if first else None
        dist.gather(wire, list(out.unbind(0)) if first else None,
                    dst=self.ranks[0], group=self.group)
        out = self._from_wire(out, t) if first else None
        self._count(kind, t0, t.numel() * t.element_size())
        return out


class FragGroup(_Collective):
    """One rank's place on the frag axis: the `size` ranks that share its
    gop index, and its `index` among them."""

    def __init__(self, group, ranks: list[int], index: int, device):
        super().__init__(group, ranks, device)
        self.index = int(index)

    def shard(self, n: int):
        """This rank's share of n fragments (JAX tpu_gop.py:160-166): nl =
        ceil(n / size) of them from index * nl on, as (nl, [nl] int64
        fragment indices, [nl] bool pad flags). A pad past n is clamped
        onto fragment n - 1; its outputs are dropped."""
        nl = -(-n // self.size)
        pos = self.index * nl + np.arange(nl)
        return nl, np.minimum(pos, n - 1), pos >= n

    def whole(self, parts: torch.Tensor, n: int, axis: int) -> torch.Tensor:
        """Gathered shards [size, ..., nl, ...] (fragments at `axis` of
        each shard) -> [..., n, ...], fragments in order."""
        t = parts.movedim(0, axis)
        shape = t.shape[:axis] + (-1,) + t.shape[axis + 2:]
        return t.reshape(shape).narrow(axis, 0, n)


class Ranks:
    """One rank's place in the mesh: `world` ranks, this one `rank`, at gop
    index `gop_index` of `groups`, on the frag axis `frag`; `everyone`,
    the group over all ranks that the rate collective and the packets'
    exchange use. Every rank must build it at the same point, since it
    creates process groups (dist.new_group) in one order."""

    def __init__(self, frag_axis: int, device: torch.device):
        self.world = dist.get_world_size()
        self.rank = dist.get_rank()
        self.groups = self.world // frag_axis
        self.gop_index = self.rank // frag_axis
        frag = None
        for g in range(self.groups):
            ranks = list(range(g * frag_axis, (g + 1) * frag_axis))
            pg = dist.new_group(ranks)
            if g == self.gop_index:
                frag = FragGroup(pg, ranks, self.rank % frag_axis, device)
        self.frag = frag
        everyone = list(range(self.world))
        self.everyone = _Collective(dist.new_group(everyone), everyone,
                                    device)

    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.frag.device) if self.everyone.route == "device" \
            else t

    def sum_once_per_gop(self, gop_bits) -> int:
        """The integer sum of per-GOP values that every rank holds alike,
        sharded over the gop axis as JAX shards them (P("gop"): the array,
        zero-padded to a multiple of the rank groups, in equal contiguous
        parts), each GOP counted once: only frag index 0 of each group
        adds its part (JAX's rate_psum also sums over "frag", fault F8)."""
        bits = np.asarray(gop_bits, np.int64).reshape(-1)
        per = max(-(-len(bits) // self.groups), 1)
        mine = bits[self.gop_index * per:(self.gop_index + 1) * per]
        local = int(mine.sum()) if self.frag.index == 0 else 0
        t = self._wire(torch.tensor([local], dtype=torch.int64))
        dist.all_reduce(t, group=self.everyone.group)
        return int(t.item())

    def exchange(self, obj) -> list:
        """Every rank's picklable obj, in rank order, on every rank."""
        blob = pickle.dumps(obj)
        size = self.everyone.all_gather(
            self._wire(torch.tensor([len(blob)], dtype=torch.int64)),
            "exchange").cpu()
        buf = torch.zeros(int(size.max()), dtype=torch.uint8)
        buf[:len(blob)] = torch.frombuffer(bytearray(blob), dtype=torch.uint8)
        parts = self.everyone.all_gather(self._wire(buf), "exchange").cpu()
        return [pickle.loads(parts[r, :int(size[r, 0])].numpy().tobytes())
                for r in range(self.world)]
