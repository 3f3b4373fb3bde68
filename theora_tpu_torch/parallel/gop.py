"""The mesh GOP encoder on one card: the gop axis as a batch dimension.

Port of theora_tpu/parallel/gop.py (`make_mesh`, `rate_psum`,
`MeshGopEncoder.encode_gops`, `encode_clip_mesh`). JAX shards a clip's
keyframe-delimited GOPs over a (gop, frag) device mesh and runs each
shard's GOPs as one batched scan (`jax.vmap(one_gop)`, parallel/gop.py:123).
On one card the port keeps that batch: a mesh of G GOPs is one dispatch of
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
is an integer sum. The frag axis (fragments of a frame over cards) and a
gop axis over several cards are not ported (ROADMAP.md §1 item 9b).
Batches run one after another, as in JAX.
"""
from __future__ import annotations

import numpy as np

from theora_tpu_torch import resolve_device
from theora_tpu_torch.encode.gop import GopEncoder, WindowRateController, \
    gop_starts
from theora_tpu_torch.encode.rate import RateControl, twopass_window_qvecs
from theora_tpu_torch.info import TheoraInfo
from theora_tpu_torch.ops.idct_cuda import MAX_SEGMENTS
from theora_tpu_torch.tpkt import Packet


class Mesh:
    """A mesh on one card: `shape` {"gop": G, "frag": 1}, G the GOPs that
    one dispatch encodes side by side, and `device`, the card (or the CPU)
    they run on."""

    def __init__(self, gop: int, device):
        self.shape = {"gop": int(gop), "frag": 1}
        self.device = device

    def __repr__(self) -> str:
        return f"Mesh(shape={self.shape}, device={self.device})"


def make_mesh(n_devices: int | None = None, frag_axis: int = 1,
              devices=None) -> Mesh:
    """A one-card mesh whose gop axis is n_devices GOPs per dispatch (1 by
    default; JAX's argument counts the devices of its mesh, and on one card
    each of its places on the gop axis is a GOP of the batch).

    devices: a list of one torch device or device name ("cuda" by default,
    "cpu" runs the plain PyTorch versions of the kernels). frag_axis > 1,
    and more than one device, raise NotImplementedError: the frag axis and
    a gop axis over several cards are ROADMAP.md §1 item 9b."""
    if frag_axis != 1:
        raise NotImplementedError(
            f"frag_axis={frag_axis}: the frag axis (fragments of a frame "
            f"over several cards) is not ported; ROADMAP.md §1 item 9b")
    devices = ["cuda"] if devices is None else list(devices)
    if len(devices) != 1:
        raise NotImplementedError(
            f"{len(devices)} devices: a gop axis over several cards over "
            f"torch.distributed is not ported; ROADMAP.md §1 item 9b")
    gop = 1 if n_devices is None else int(n_devices)
    if not 1 <= gop <= MAX_SEGMENTS:
        raise ValueError(f"n_devices: the gop axis must be 1..{MAX_SEGMENTS}"
                         f" GOPs per dispatch, got {n_devices}")
    return Mesh(gop, resolve_device(devices[0]))


def rate_psum(mesh: Mesh, gop_bits: np.ndarray) -> int:
    """The CBR collective: the sum of per-GOP real packed bit counts over
    the mesh (JAX: a psum over the gop and frag axes). On one card it is
    the integer sum."""
    return int(np.asarray(gop_bits, np.int64).sum())


class MeshGopEncoder:
    """GopEncoder over a mesh's gop axis: batches of G equal-length GOPs,
    one dispatch each, G GOPs side by side in every plane scan; the host
    packs each GOP's frames afterwards. `base` is the GopEncoder on the
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
        accepted for JAX's signature and unused there as here."""
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
        me_state = base.dispatch_me([fr for gop in gops for fr in gop],
                                    kf_flags=([True] + [False] * (F - 1)) * G)
        me_state.gop_axis = G
        datas, _ = base.finish_gop(base.complete_dispatch(me_state,
                                                          frame_qi=flat_qi))
        return [datas[gi * F:(gi + 1) * F] for gi in range(G)]


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
