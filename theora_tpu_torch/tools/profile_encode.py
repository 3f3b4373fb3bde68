"""Where the device GOP encode's time goes on the card.

Usage: python -m theora_tpu_torch.tools.profile_encode [--repeat R] [--frames N]
           [--qi Q] [--adaptive-quant {auto,on,off}] [--speed S]
           [--bitrate B [--two-pass]] [--transcode | --staged | --mesh G]
           [--save-ogv PATH]

Counterpart of `--mode encode` in theora_tpu/tools/profile.py. Encodes
the 1280x720 test clip (testdata/make_hd720.py's source frames, q48 and
adaptive_quant=False unless asked otherwise, a keyframe every 8 frames,
clip_batch 8; at speed level S; with B > 0 in CBR at B bit/s, or with
--two-pass an encode_clip_twopass at B with a 16-frame rate buffer and
no quality floor) once to warm up, then R more times: untraced passes
timed on the host clock (wall, host mode decision, host packing, host
waits for the device's copies, device spans from CUDA events), and one
pass under torch.profiler, which reports device time per codec stage
(the record_function labels in encode/gop.py and encode/scan.py) with
the PyTorch kernels each launches, per kernel, the launches of the
kernel libraries (K1 at all its entries, K2, KT, KR, KM, KL, KS) and of
K1 in the theora.enc.idct_recon scope, the launches of the fused entries
that run KS's MC, skip test and plane assembly (theora.enc.fdct_quant or
fdct_quant_rd, and theora.enc.idct_recon) and KS's own, and the device's
busy and idle share of the traced pass. Then one speed-of-light line per
hand-kernel stage (KM; K2 and KR's entries with KS's MC as their head;
KT; K1's fused encode entry with KS's skip test and plane assembly and
its decode entry; the loop filter KL, which runs where a frame's qi is
below 47; KS's place and decode entries): its kernels' device time in
the traced pass beside the bound of the same calls (tools/bench_me.py,
bench_fdct.py, bench_trellis.py, bench_qrd.py, bench_idct.py,
bench_loopfilter.py, bench_mc.py), which one more, untraced pass
records at the run's shapes and data. With --save-ogv PATH the last timed pass's packets are
written to PATH as an Ogg stream (profile_decode.py reads it). With
--transcode the pass is instead the device-resident transcode
(encode/gop.py:transcode_device) of the first N data packets of
testdata/hd720_q56_k12.ogv in decode
batches of 8 at qi Q with the encoder's settings (adaptive quantization
"auto" unless asked otherwise), whose encoder's host timers are not
reported. With --staged the 8-frame GOPs go one after another through
dispatch_me, complete_dispatch and finish_gop, where encode_clip runs
them two deep. With --mesh G the pass is the mesh encoder's
encode_clip_mesh (parallel/gop.py) on a gop axis of G, G GOPs per
dispatch, at the mesh's adaptive quantization "auto" (CBR with --bitrate
B); its encoder's host timers are not reported. Needs a CUDA card.
Prints one JSON summary as its last line.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

import torch

from theora_tpu_torch.tools.profile_decode import _split

_TESTDATA = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "testdata")
QI, KF, BATCH = 48, 8, 8


def hd720_frames(n: int):
    """The first n frames of testdata/make_hd720.py's 1280x720 clip."""
    spec = importlib.util.spec_from_file_location(
        "make_hd720", os.path.join(_TESTDATA, "make_hd720.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.source_frames()[:n]


def traced(fn, device="cuda", chrome_trace=None):
    """fn() once under torch.profiler (CPU activity, and CUDA activity on
    the card, which is synchronised before and after it): (its return
    value, the profiler's events, the wall in seconds). With chrome_trace
    a path, the trace is written there as Chrome trace JSON."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(device).type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = fn()
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if chrome_trace is not None:
        prof.export_chrome_trace(chrome_trace)
    return out, prof.events(), wall


def device_launches(events) -> tuple[int, float]:
    """(device kernels launched, their device seconds) among the events."""
    kernels = _split(events)[1]
    return (sum(c for _, c in kernels.values()),
            sum(sec for sec, _ in kernels.values()))


def _stage_kernels(events) -> dict:
    """{stage: device kernels launched by the PyTorch ops inside its
    record_function ranges} from the profiler's events. A CUDA runtime
    call right under a range is a kernel library's launch (a PyTorch op
    launches under its own event), which its wrapper counts; it is left
    out, with whatever kernels the profiler ties to it (it has tied other
    ops' kernels to such a launch)."""
    from torch.autograd import DeviceType

    def count(e):
        return len(e.kernels) + sum(
            count(c) for c in e.cpu_children
            if not (e.name.startswith("theora.")
                    and c.name.startswith("cuda")))

    out = {}
    for e in events:
        if e.device_type == DeviceType.CPU and e.name.startswith("theora."):
            out[e.name] = out.get(e.name, 0) + count(e)
    return out


def _kernel_stages() -> list:
    """(stage, wrapper module, wrapper name, device kernel names, bound of
    one call's arguments) for each hand kernel an encode may launch."""
    from theora_tpu_torch.ops import fdct_cuda, idct_cuda, loopfilter_cuda, \
        mc_cuda, me_cuda, postproc_cuda, qrd_cuda, trellis_cuda
    from theora_tpu_torch.tools import bench_idct, bench_loopfilter, \
        bench_mc, bench_me, bench_pp, bench_trellis

    return [
        ("ME plan (KM)", me_cuda, "plan_with_gold",
         ("me_search_kernel", "me_cands_kernel", "me_cand_sads_kernel"),
         lambda a: bench_me.km_bound(a[0])),
        ("MC + fDCT + quantization (K2 with KS's MC)", fdct_cuda,
         "mc_fdct_quantize", ("fdct_quant_kernel",),
         lambda a: bench_mc.fused_bound("mc_fdct_quantize", a)),
        ("trellis (KT)", trellis_cuda, "trellis_quantize",
         ("trellis_kernel",), bench_trellis.kt_bound),
        ("MC + fDCT + R/D quantizer (KR with KS's MC)", qrd_cuda,
         "mc_fdct_quantize_rd", ("fdct_qrd_kernel",),
         lambda a: bench_mc.fused_bound("mc_fdct_quantize_rd", a)),
        ("MC + recon + qi chooser + skip test + plane (K1 with KS)",
         idct_cuda, "mc_idct_recon_skip", ("mc_idct_recon_skip_kernel",),
         lambda a: bench_mc.fused_bound("mc_idct_recon_skip", a)),
        ("dequant + iDCT (K1 decode entry)", idct_cuda,
         "dequantize_idct_frames", ("dequant_idct_kernel",),
         lambda a: bench_idct.k1_bound("decode", a)),
        ("loop filter (KL)", loopfilter_cuda, "loop_filter_plane",
         ("loop_filter_kernel",), bench_loopfilter.kl_bound),
        ("plane of the gathered rows (KS place_rows)", mc_cuda,
         "place_rows", ("place_kernel",),
         lambda a: bench_mc.ks_bound("place_rows", a)),
        ("MC + recon (KS mc_recon)", mc_cuda, "mc_recon",
         ("mc_recon_kernel",), lambda a: bench_mc.ks_bound("mc_recon", a)),
        ("postprocess (KP)", postproc_cuda, "postprocess_frames",
         ("th_pp_deblock_kernel", "th_pp_dering_kernel"),
         bench_pp.frames_bound),
    ]


def stage_bounds(fn) -> dict:
    """fn() once with each hand kernel's wrapper replaced by one that
    calls it and adds the bound of its arguments (tools/bench_*.py; a
    bound may copy its inputs to the host). Returns {stage: (bound
    seconds, calls, what binds)}. The wrappers are restored after."""
    import inspect

    out = {}
    saved = []

    def recorder(stage, real, bound):
        sig = inspect.signature(real)

        def call(*args, **kwargs):
            res = real(*args, **kwargs)
            ba = sig.bind(*args, **kwargs)
            ba.apply_defaults()
            b = bound(tuple(ba.arguments.values()))
            sec, calls, by = out.get(stage, (0.0, 0, set()))
            out[stage] = (sec + b["bound_ms"] / 1e3, calls + 1,
                          by | {b["bound_by"]})
            return res

        call.launches = 0
        return call

    try:
        for stage, mod, attr, _, bound in _kernel_stages():
            real = getattr(mod, attr)
            saved.append((mod, attr, real))
            setattr(mod, attr, recorder(stage, real, bound))
        fn()
    finally:
        for mod, attr, real in saved:
            setattr(mod, attr, real)
    return {k: (sec, calls, "/".join(sorted(by)))
            for k, (sec, calls, by) in out.items()}


def speed_of_light(kernels: dict, bounds: dict) -> dict:
    """{stage: {traced device seconds of its kernels, their launches, the
    bound of the same calls, what binds, the share of the bound}} for each
    hand-kernel stage the encode ran, printed one line each."""
    rows = {}
    for stage, _, _, names, _ in _kernel_stages():
        if stage not in bounds:
            continue
        sec = sum(v[0] for k, v in kernels.items()
                  if any(nm in k for nm in names))
        launches = sum(v[1] for k, v in kernels.items()
                       if any(nm in k for nm in names))
        bsec, calls, by = bounds[stage]
        rows[stage] = {"traced_s": sec, "launches": launches,
                       "bound_s": bsec, "bound_by": by, "calls": calls,
                       "share_of_bound": bsec / sec if sec else None}
        share = f"{100 * bsec / sec:.1f}%" if sec else "not measured"
        print(f"[speed of light] {stage}: traced {1e3 * sec:.4f} ms device "
              f"in {launches} launches ({calls} calls); bound "
              f"{1e3 * bsec:.4f} ms by {by}; at {share} of its bound",
              flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--repeat", type=int, default=3)
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--qi", type=int, default=QI)
    ap.add_argument("--adaptive-quant", choices=["auto", "on", "off"],
                    default=None)
    ap.add_argument("--speed", type=int, default=0)
    ap.add_argument("--bitrate", type=int, default=0)
    ap.add_argument("--two-pass", action="store_true")
    ap.add_argument("--transcode", action="store_true")
    ap.add_argument("--staged", action="store_true")
    ap.add_argument("--mesh", type=int, default=0, metavar="G")
    ap.add_argument("--save-ogv", default=None, metavar="PATH")
    args = ap.parse_args(argv)
    if args.two_pass and not args.bitrate:
        ap.error("--two-pass requires --bitrate")
    if args.transcode and (args.two_pass or args.speed or args.staged):
        ap.error("--transcode takes no --two-pass, --speed or --staged")
    if args.staged and (args.two_pass or args.bitrate or args.save_ogv):
        ap.error("--staged takes no --bitrate or --save-ogv")
    if args.mesh and (args.transcode or args.staged or args.two_pass
                      or args.speed or args.adaptive_quant not in (None,
                                                                   "auto")):
        ap.error("--mesh takes no --transcode, --staged, --two-pass, "
                 "--speed or --adaptive-quant other than auto")
    qi = args.qi
    aq = {"auto": "auto", "on": True, "off": False}[
        args.adaptive_quant or ("auto" if args.transcode or args.mesh
                                else "off")]
    if not torch.cuda.is_available():
        print("profile_encode: needs a CUDA card", file=sys.stderr)
        return 2

    from theora_tpu_torch.encode.gop import GopEncoder, transcode_device
    from theora_tpu_torch.info import TheoraInfo
    from theora_tpu_torch.parallel.gop import encode_clip_mesh, make_mesh

    if args.transcode:
        from theora_tpu_torch.headers import parse_info_header, \
            parse_setup_header
        from theora_tpu_torch.ogg import demux_stream

        with open(os.path.join(_TESTDATA, "hd720_q56_k12.ogv"), "rb") as f:
            pkts = demux_stream(f.read())
        src_info = parse_info_header(pkts[0].data)
        src_setup = parse_setup_header(pkts[2].data)
        frames = [p.data for p in pkts[3:3 + args.frames]]
    else:
        frames = hd720_frames(args.frames)
    info = TheoraInfo(frame_width=1280, frame_height=720, pic_width=1280,
                      pic_height=720, quality=0 if args.two_pass else qi)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]

    def make():
        if args.transcode or args.mesh:
            return None
        enc = GopEncoder(info, qi=qi, adaptive_quant=aq)
        enc.set_splevel(args.speed)
        return enc

    def encode(enc):
        if args.mesh:
            return encode_clip_mesh(frames, info, make_mesh(args.mesh),
                                    keyframe_freq=KF, qi=qi,
                                    target_bitrate=args.bitrate)
        if args.transcode:
            return transcode_device(src_info, src_setup, frames,
                                    keyframe_freq=KF, qi=qi,
                                    target_bitrate=args.bitrate,
                                    enc_kwargs={"adaptive_quant": aq})
        if args.staged:
            for base in range(0, len(frames), KF):
                enc.finish_gop(enc.dispatch_gop(frames[base:base + KF]))
            return None
        if args.two_pass:
            return enc.encode_clip_twopass(
                frames, keyframe_freq=KF, target_bitrate=args.bitrate,
                buf_delay=16)[0]
        return enc.encode_clip(frames, keyframe_freq=KF, clip_batch=BATCH,
                               target_bitrate=args.bitrate)

    encode(make())  # warm
    runs = []
    for _ in range(args.repeat):
        enc = make()
        if enc is not None:
            enc.device_spans = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pkts = encode(enc)
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        run = {"wall_s": wall}
        if enc is not None:
            run.update(
                host_decide_s=enc.host_decide_s,
                host_pack_s=enc.host_pack_s, host_wait_s=enc.host_wait_s,
                device_span_s=sum(a.elapsed_time(b)
                                  for a, b in enc.device_spans) / 1e3)
        runs.append(run)
        print("[run] " + ", ".join(f"{k} {v:.4f}" for k, v in run.items()),
              flush=True)
    if args.save_ogv:
        from theora_tpu_torch.ogg import mux_stream

        with open(args.save_ogv, "wb") as f:
            f.write(mux_stream(pkts))
        print(f"[save] {len(pkts)} packets -> {args.save_ogv}", flush=True)

    from theora_tpu_torch.ops import fdct_cuda, idct_cuda, loopfilter_cuda, \
        mc_cuda, me_cuda, qrd_cuda, trellis_cuda

    # K1 counts all its entries; the encode launches its fused encode
    # entry, K2 and KR theirs (KS's MC, skip test and plane assembly run
    # inside them).
    wrappers = {"K1": (idct_cuda.dequantize_idct_frames,
                       idct_cuda.idct_recon_choose,
                       idct_cuda.mc_idct_recon_skip),
                "K2": (fdct_cuda.fdct_quantize, fdct_cuda.mc_fdct_quantize),
                "KT": (trellis_cuda.trellis_quantize,),
                "KR": (qrd_cuda.fdct_quantize_rd,
                       qrd_cuda.mc_fdct_quantize_rd),
                "KM": (me_cuda.plan_with_gold,),
                "KL": (loopfilter_cuda.loop_filter_plane,),
                "KS": mc_cuda.ENTRIES}

    fused = (fdct_cuda.mc_fdct_quantize, qrd_cuda.mc_fdct_quantize_rd,
             idct_cuda.mc_idct_recon_skip)

    def lib_counts():
        return {**{k: sum(w.launches for w in ws)
                   for k, ws in wrappers.items()},
                "fused": sum(w.launches for w in fused)}

    before = lib_counts()
    enc = make()
    _, events, traced_wall = traced(lambda: encode(enc))
    stages, kernels = _split(events)
    stage_kernels = _stage_kernels(events)
    lib_launches = {k: c - before[k] for k, c in lib_counts().items()}
    kernels = sorted(((k, sec, c) for k, (sec, c) in kernels.items()),
                     key=lambda k: -k[1])
    busy = sum(k[1] for k in kernels)
    for name, sec in sorted(stages.items(), key=lambda kv: -kv[1]):
        print(f"[stage] {name}: {sec:.6f} s device, "
              f"{stage_kernels.get(name, 0)} PyTorch kernels", flush=True)
    # K1, K2, KT, KR, KM, KL and KS are launched from their own libraries,
    # outside any PyTorch op, so the profiler does not attribute them to
    # their scopes; list them by name, and their launches by their
    # wrappers' counts.
    print(f"[launches] kernel libraries in the traced pass: {lib_launches}",
          flush=True)
    print(f"[launches] theora.enc.idct_recon: "
          f"{stage_kernels.get('theora.enc.idct_recon', 0)} PyTorch kernels "
          f"+ {lib_launches['K1']} K1 launches = "
          f"{lib_launches['K1'] / (3 * len(frames)):.2f} per plane per "
          f"frame", flush=True)
    print(f"[launches] theora.enc.loopfilter: "
          f"{stage_kernels.get('theora.enc.loopfilter', 0)} PyTorch kernels "
          f"+ {lib_launches['KL']} KL launches", flush=True)
    fused_scopes = ("theora.enc.fdct_quant", "theora.enc.fdct_quant_rd",
                    "theora.enc.idct_recon")
    fused_torch = sum(stage_kernels.get(k, 0) for k in fused_scopes)
    print(f"[launches] KS fused into K2 or KR and K1 "
          f"({' + '.join(fused_scopes)}): {fused_torch} PyTorch kernels + "
          f"{lib_launches['fused']} fused-entry launches = "
          f"{(fused_torch + lib_launches['fused']) / (3 * len(frames)):.2f}"
          f" per plane per frame; KS's own launches {lib_launches['KS']} "
          f"(a transcode's decode, a frag group's place entry)", flush=True)
    shown = kernels[:20] + [k for k in kernels[20:]
                            if any(w in k[0]
                                   for w in ("idct", "fdct", "trellis",
                                             "qrd", "me_", "loop_filter",
                                             "mc_re", "place_kernel"))]
    for name, sec, count in shown:
        print(f"[kernel] {sec:.6f} s x{count} {name[:100]}", flush=True)
    nf = len(frames)
    # The hand kernels' device time (KM's is theora.enc.me's) beside
    # their bounds.
    sol = speed_of_light(_split(events)[1], stage_bounds(
        lambda: encode(make())))
    launches = sum(k[2] for k in kernels)
    per_plane_frame = launches / (3 * nf)
    print(f"[launches] {launches} device kernels in the traced pass, "
          f"{per_plane_frame:.1f} per plane per frame", flush=True)
    mid = sorted(r["wall_s"] for r in runs)[len(runs) // 2]
    summary = {
        "card": smi, "frames": nf, "qi": qi, "adaptive_quant": aq,
        "speed": args.speed, "bitrate": args.bitrate,
        "two_pass": args.two_pass, "transcode": args.transcode,
        "staged": args.staged, "mesh_gop_axis": args.mesh,
        "keyframe_freq": KF,
        "clip_batch": BATCH, "median_wall_s": mid,
        "frames_per_s": nf / mid,
        "mpix_per_s": nf * 1280 * 720 * 1.5 / 1e6 / mid,
        "runs": runs, "traced_wall_s": traced_wall,
        "traced_device_busy_s": busy,
        "traced_idle_share": 1.0 - busy / traced_wall,
        "traced_host_decide_s": None if enc is None else enc.host_decide_s,
        "traced_host_pack_s": None if enc is None else enc.host_pack_s,
        "traced_host_wait_s": None if enc is None else enc.host_wait_s,
        "stages_device_s": stages,
        "stages_pytorch_kernels": stage_kernels,
        "library_launches": lib_launches,
        "speed_of_light": sol,
        "kernel_launches": launches,
        "launches_per_plane_frame": per_plane_frame,
    }
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
