"""The mesh GOP encoder: the gop axis as a batch dimension on one card, and
the (gop, frag) mesh over torch.distributed ranks, one rank per device.

Port of theora_tpu/parallel/gop.py (`make_mesh`, `rate_psum`,
`MeshGopEncoder.encode_gops`, `encode_clip_mesh`). JAX shards a clip's
keyframe-delimited GOPs over a (gop, frag) device mesh and runs each
shard's GOPs as one batched scan (`jax.vmap(one_gop)`, parallel/gop.py:123).
Without a process group (or in a world of one) the mesh is one card, and
the port keeps that batch: a mesh of G GOPs is one dispatch of
the device encoder (encode/gop.py) whose ME plan covers the G GOPs' frames
at once and whose plane scans (encode/scan.py) run the G GOPs side by side
on their GOP axis, each kernel launching once per plane per frame step
over all G GOPs' blocks (the GOPs are the kernels' segments, each with its
own quantizer rows and lambdas). So a clip of G-GOP batches makes about
1/G of the sequential encode's launches per frame.

The packets equal JAX's encode_clip_mesh's on every mesh shape: each GOP
keeps its own qi list per frame (the content gates run per GOP and frame,
keyframe_only only where the batch is one frame long), rate control moves
the qi between batches only, at fixed GOP indices, and the CBR collective
is an integer sum. Batches run one after another, as in JAX.

With a default process group of W > 1 ranks, each on its own device
(parallel/ranks.py), the mesh spans the ranks as JAX's spans its devices:
rank r sits at gop index r // frag_axis and frag index r % frag_axis. A
batch's G GOPs split evenly over the W // frag_axis rank groups, and each
group runs its share side by side on its device as above. Inside a group
the Fr = frag_axis ranks split every frame's fragments (encode/scan.py)
and gather their reconstructed blocks at each frame step; the group's
first rank gathers the chunk's coefficients and packs (encode/gop.py).
The packets of every batch then go to every rank, in GOP order, so every
rank returns the same packet list, and the CBR count is an all-reduce in
which each GOP counts once (JAX's counts each frag_axis times: fault F8,
ROADMAP.md §3).

Usage (per rank; the tests use gloo on the CPU):
    torch.distributed.init_process_group(
        "gloo", init_method="tcp://localhost:<port>", world_size=W,
        rank=r)
    mesh = make_mesh(W, frag_axis=2, devices=["cpu"])  # {gop W/2, frag 2}
    pkts = encode_clip_mesh(frames, info, mesh, keyframe_freq=8)
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from theora_tpu_torch import resolve_device
from theora_tpu_torch.encode.gop import GopEncoder, WindowRateController, \
    gop_starts
from theora_tpu_torch.encode.rate import RateControl, twopass_window_qvecs
from theora_tpu_torch.info import TheoraInfo
from theora_tpu_torch.ops.idct_cuda import MAX_SEGMENTS
from theora_tpu_torch.parallel.ranks import Ranks
from theora_tpu_torch.tpkt import Packet


class Mesh:
    """A mesh: `shape` {"gop": G, "frag": Fr}, G the GOPs of a batch and Fr
    the ranks that split each frame's fragments; `device`, this rank's
    card (or the CPU); `ranks`, its parallel/ranks.py Ranks, or None on
    one card (Fr 1)."""

    def __init__(self, gop: int, device, frag: int = 1, ranks=None):
        self.shape = {"gop": int(gop), "frag": int(frag)}
        self.device = device
        self.ranks = ranks

    def __repr__(self) -> str:
        where = "" if self.ranks is None else \
            f", rank {self.ranks.rank} of {self.ranks.world}"
        return f"Mesh(shape={self.shape}, device={self.device}{where})"


def _world() -> int:
    return dist.get_world_size() if dist.is_available() and \
        dist.is_initialized() else 1


def make_mesh(n_devices: int | None = None, frag_axis: int = 1,
              devices=None) -> Mesh:
    """A mesh of shape {"gop": n_devices // frag_axis, "frag": frag_axis},
    as JAX's make_mesh lays n_devices devices out.

    Without a process group, or in a world of one rank, the mesh is one
    card: its gop axis is n_devices GOPs per dispatch (1 by default),
    frag_axis must be 1, and devices is a list of one torch device or
    device name ("cuda" by default; "cpu" runs the plain PyTorch versions
    of the kernels).

    With a default process group of W > 1 ranks (every rank calls this at
    the same point: it creates process groups), n_devices counts the
    mesh's places (W by default), rank r sits at gop index r // frag_axis
    and frag index r % frag_axis, and the batch's G GOPs split evenly over
    the W // frag_axis rank groups. devices names this rank's one device;
    by default cuda:{local rank % cards}, the local rank from LOCAL_RANK,
    else the rank. Without a card and without devices it raises, as every
    entry point does.

    Raises ValueError when frag_axis > 1 has no process group to span,
    when frag_axis does not divide W or n_devices, when the gop axis does
    not divide over the rank groups, or when a group's share of GOPs lies
    outside 1..MAX_SEGMENTS."""
    frag = int(frag_axis)
    if frag < 1:
        raise ValueError(f"frag_axis must be 1 or more, got {frag_axis}")
    devices = None if devices is None else list(devices)
    if devices is not None and len(devices) != 1:
        raise ValueError(
            f"{len(devices)} devices: a rank runs on one device; a mesh "
            f"over several devices is a process group of one rank each")
    world = _world()
    if world == 1:
        if frag != 1:
            raise ValueError(
                f"frag_axis={frag}: the frag axis spans the ranks of a "
                f"torch.distributed process group, and none of more than "
                f"one rank is initialised")
        gop = 1 if n_devices is None else int(n_devices)
        if not 1 <= gop <= MAX_SEGMENTS:
            raise ValueError(f"n_devices: the gop axis must be 1..."
                             f"{MAX_SEGMENTS} GOPs per dispatch, got "
                             f"{n_devices}")
        return Mesh(gop, resolve_device("cuda" if devices is None
                                        else devices[0]))
    places = world if n_devices is None else int(n_devices)
    if world % frag or places % frag:
        raise ValueError(f"frag_axis={frag} must divide the world's {world} "
                         f"ranks and the mesh's {places} places")
    gop, groups = places // frag, world // frag
    if gop % groups or not 1 <= gop // groups <= MAX_SEGMENTS:
        raise ValueError(
            f"the gop axis of {gop} GOPs does not divide over the {groups} "
            f"rank groups into 1..{MAX_SEGMENTS} GOPs each")
    if devices is None:
        resolve_device("cuda")
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        devices = [f"cuda:{local % torch.cuda.device_count()}"]
    device = resolve_device(devices[0])
    return Mesh(gop, device, frag, Ranks(frag, device))


def rate_psum(mesh: Mesh, gop_bits: np.ndarray) -> int:
    """The CBR collective: the sum of per-GOP real packed bit counts over
    the mesh, each GOP counted once (JAX: a psum over the gop and frag
    axes, which counts each GOP frag_axis times: fault F8). On one card it
    is the integer sum; over ranks an int64 all-reduce of each rank
    group's part of the array, which every rank holds alike, given by its
    frag index 0 only."""
    if mesh.ranks is None:
        return int(np.asarray(gop_bits, np.int64).sum())
    return mesh.ranks.sum_once_per_gop(gop_bits)


class MeshGopEncoder:
    """GopEncoder over a mesh: batches of G equal-length GOPs, one dispatch
    each on one card, G GOPs side by side in every plane scan; the host
    packs each GOP's frames afterwards. Over ranks each rank group
    dispatches its share of the batch. `base` is the GopEncoder on the
    mesh's device (its settings, e.g. base.set_splevel, apply)."""

    def __init__(self, mesh: Mesh, info: TheoraInfo, qi: int | None = None,
                 rd_strength: float = 3.0):
        self.mesh = mesh
        self.base = GopEncoder(info, qi=qi, rd_strength=rd_strength,
                               device=mesh.device)
        self.g = self.base.g

    def encode_gops(self, gops: list, want_sizes: bool = False,
                    frame_qi: list | None = None):
        """Encode G GOPs of equal frame counts (frame 0 of each its
        keyframe) in one dispatch. Returns a list of per-GOP packet byte
        lists.

        frame_qi: optional per-GOP per-frame base-qi vectors ([G][F] ints,
        the 2-pass controller's trajectory); None encodes everything at
        base.qi. Every frame's qi list comes from the adaptive-quantization
        gates on its own luma, keyframe_only where F == 1; the dispatch
        pads every list to the longest of all G * F. want_sizes is
        accepted for JAX's signature and unused there as here.

        Over ranks, rank group k encodes GOPs k * G / groups onward (G must
        divide over the groups); every rank returns all G GOPs' packets."""
        base = self.base
        G = len(gops)
        F = len(gops[0]) if G else 0
        if G < 1 or F < 1 or any(len(x) != F for x in gops):
            raise ValueError("encode_gops takes one or more GOPs of equal, "
                             "nonzero frame counts")
        flat_qi = None
        if frame_qi is not None:
            if len(frame_qi) != G or any(len(qv) != F for qv in frame_qi):
                raise ValueError("frame_qi must give [G][F] qis")
            flat_qi = [int(q) for qv in frame_qi for q in qv]
        ranks = self.mesh.ranks
        mine = range(G)
        if ranks is not None:
            if G % ranks.groups:
                raise ValueError(f"{G} GOPs do not divide over the mesh's "
                                 f"{ranks.groups} rank groups")
            per = G // ranks.groups
            mine = range(ranks.gop_index * per, (ranks.gop_index + 1) * per)
        me_state = base.dispatch_me(
            [fr for gi in mine for fr in gops[gi]],
            kf_flags=([True] + [False] * (F - 1)) * len(mine))
        me_state.gop_axis = len(mine)
        if ranks is not None and ranks.frag.size > 1:
            me_state.frag = ranks.frag
        datas, _ = base.finish_gop(base.complete_dispatch(
            me_state, frame_qi=None if flat_qi is None
            else flat_qi[mine[0] * F:(mine[-1] + 1) * F]))
        out = None if datas is None else [
            datas[k * F:(k + 1) * F] for k in range(len(mine))]
        if ranks is None:
            return out
        # Each group's first rank packed its GOPs; every rank gets all.
        everyone = ranks.exchange(out)
        return [pk for r in range(0, ranks.world, ranks.frag.size)
                for pk in everyone[r]]


def encode_clip_mesh(
    frames: list,
    info: TheoraInfo,
    mesh: Mesh,
    keyframe_freq: int = 8,
    qi: int | None = None,
    target_bitrate: int = 0,
    rate_window: int = 8,
    auto_keyframe: bool = False,
    twopass_data: bytes | None = None,
    buf_delay: int | None = None,
) -> list[Packet]:
    """Encode a clip over the mesh in batches of up to mesh.shape["gop"]
    GOPs (theora_tpu/parallel/gop.py:400-563); headers first.

    Equal-shape batches: a short GOP repeats its last frame, and a short
    batch is padded with copies of its first GOP; those outputs are
    dropped. auto_keyframe places GOP starts at scene cuts (bounded by
    keyframe_freq) from the content alone, so every mesh shape sees the
    same, possibly uneven, GOPs.

    With target_bitrate > 0 a batch is clipped at the next boundary of
    rate_window GOPs, where the window controller (WindowRateController)
    moves the qi from the real packed bits (rate_psum); with twopass_data
    (a pass-1 metrics blob) every frame's qi of a window of rate_window
    GOPs comes from the controller's model pre-pass
    (twopass_window_qvecs), and the controller replays each frame with its
    real bits between windows. Either way the qi trajectory, and so every
    byte, is the same on every mesh shape."""
    enc = MeshGopEncoder(mesh, info, qi=qi)
    G = mesh.shape["gop"]
    out = enc.base.flush_headers()
    shift = info.keyframe_granule_shift
    nf = len(frames)
    starts = gop_starts(frames, keyframe_freq, auto_keyframe)
    bounds = starts + [nf]
    gop_list = [(starts[k], frames[starts[k]:bounds[k + 1]])
                for k in range(len(starts))]
    pno = len(out)

    def emit(base_f, datas):
        nonlocal pno
        for j, data in enumerate(datas):
            fnum = base_f + j
            out.append(Packet(data, granulepos=((base_f + 1) << shift) + j,
                              packetno=pno, e_o_s=(fnum == nf - 1)))
            pno += 1

    def padded(batch, qvecs=None):
        """The batch's GOPs, each repeating its last frame up to the
        longest, and copies of the first up to G; with qvecs their qis
        padded alike."""
        F = max(len(gp) for _, gp in batch)
        gops = [gp + [gp[-1]] * (F - len(gp)) for _, gp in batch]
        qv = None if qvecs is None else [q + [q[-1]] * (F - len(q))
                                         for q in qvecs]
        while len(gops) < G:
            gops.append(gops[0])
            if qv is not None:
                qv.append(qv[0])
        return gops, qv

    if twopass_data is not None:
        rc2 = RateControl(enc.base._rc_info(target_bitrate), keyframe_freq)
        rc2.start_pass2(twopass_data, buf_delay)
        prev_applied = enc.base.qi
        for w0 in range(0, len(gop_list), rate_window):
            window = gop_list[w0:w0 + rate_window]
            qvecs = twopass_window_qvecs(
                rc2, [len(gp) for _, gp in window], prev_applied)
            results = []
            for c0 in range(0, len(window), G):
                batch = window[c0:c0 + G]
                gops, qv = padded(batch, qvecs[c0:c0 + G])
                results.extend(enc.encode_gops(gops, frame_qi=qv)
                               [:len(batch)])
            for (base_f, gfr), pk, qv in zip(window, results, qvecs):
                emit(base_f, pk[:len(gfr)])
                for j in range(len(gfr)):
                    # The controller replays each frame with its real
                    # bits, in frame order; its own selection is discarded.
                    ftype = 0 if j == 0 else 1
                    rc2.select_qi(ftype, prev_applied)
                    rc2.log_qtarget = rc2.log_qavg[ftype][qv[j]]
                    rc2.update(ftype, qv[j], 8 * len(pk[j]))
                    prev_applied = qv[j]
        return out

    rc = WindowRateController(enc.base, target_bitrate, rate_window)
    win_bits: list[int] = []
    win_frames = 0

    def rate_update():
        nonlocal win_frames
        if not win_bits:
            return
        rc.apply(rate_psum(mesh, np.asarray(win_bits, np.int64)),
                 win_frames)
        win_bits.clear()
        win_frames = 0

    b0 = 0
    while b0 < len(gop_list):
        size = min(G, len(gop_list) - b0)
        if target_bitrate > 0:
            # A qi update never lands inside a batch: clip the batch at
            # the next rate-window boundary.
            size = min(size, rate_window - b0 % rate_window)
        batch = gop_list[b0:b0 + size]
        pkts = enc.encode_gops(padded(batch)[0])
        for gi, (base_f, gfr) in enumerate(batch):
            datas = pkts[gi][:len(gfr)]
            emit(base_f, datas)
            if target_bitrate > 0:
                win_bits.append(8 * sum(len(d) for d in datas))
                win_frames += len(gfr)
                if (b0 + gi + 1) % rate_window == 0:
                    rate_update()
        b0 += size
    if target_bitrate > 0:
        rate_update()
    return out
