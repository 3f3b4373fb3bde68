"""Where the batch decode's time goes on the card.

Usage: python -m theora_tpu_torch.tools.profile_decode [--repeat R] [in.ogv]

Counterpart of `--mode decode` in theora_tpu/tools/profile.py. Decodes
the stream once to warm up, then R more times: untraced passes timed on
the host clock (wall, host parse, device spans from CUDA events), and one
pass under torch.profiler, which reports device time per codec stage
(the record_function labels in decode/batch.py), per kernel, the
launches of K1, of the loop filter KL and of KS's decode entry (MC and
reconstruction, and the borders of the frames KL does not filter) with
the PyTorch kernels of the theora.mc_recon and theora.borders scopes per
plane per frame, and the device's busy and idle share of the traced
pass. Then one speed-of-light line per hand kernel the decode ran (K1's
decode entry; KL where a frame's qi is below 47; KS's decode entry): its
kernels' device time in the traced pass beside the bound of the same
calls (tools/bench_idct.py, bench_loopfilter.py, bench_mc.py), which one
more, untraced pass records (profile_encode.py:stage_bounds). Needs a CUDA
card. Prints one JSON summary as its last line.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
_DEFAULT = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "testdata",
                        "hd720_q56_k12.ogv")
BATCH = 8


def _split(events):
    """(stage device seconds, {kernel name: (seconds, count)}) from the
    profiler's events. A stage is the CPU-side record_function range:
    its device time sums the kernels launched inside it. Kernels are
    the device-side events other than the annotation ranges."""
    from torch.autograd import DeviceType

    stages, kernels = {}, {}
    for e in events:
        if e.device_type == DeviceType.CPU:
            if e.name.startswith("theora."):
                stages[e.name] = stages.get(e.name, 0.0) \
                    + e.device_time_total / 1e6
        elif not e.name.startswith("theora."):
            sec, count = kernels.get(e.name, (0.0, 0))
            kernels[e.name] = (sec + e.time_range.elapsed_us() / 1e6,
                               count + 1)
    return stages, kernels


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("input", nargs="?", default=_DEFAULT)
    ap.add_argument("--repeat", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_decode: needs a CUDA card", file=sys.stderr)
        return 2

    from torch.profiler import ProfilerActivity, profile

    from theora_tpu_torch.decode.batch import BatchDecoder
    from theora_tpu_torch.headers import parse_info_header, \
        parse_setup_header
    from theora_tpu_torch.ogg import demux_stream
    from theora_tpu_torch.ops import idct_cuda, loopfilter_cuda, mc_cuda
    from theora_tpu_torch.tools.profile_encode import _stage_kernels, \
        speed_of_light, stage_bounds

    with open(args.input, "rb") as f:
        pkts = demux_stream(f.read())
    info = parse_info_header(pkts[0].data)
    setup = parse_setup_header(pkts[2].data)
    data = [p.data for p in pkts[3:]]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]

    BatchDecoder(info, setup).decode_clip(data, batch=BATCH)  # warm
    runs = []
    for _ in range(args.repeat):
        dec = BatchDecoder(info, setup)
        dec.device_spans = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dec.decode_clip(data, batch=BATCH)
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        spans = sum(a.elapsed_time(b) for a, b in dec.device_spans) / 1e3
        runs.append({"wall_s": wall, "host_parse_s": dec.host_parse_s,
                     "device_span_s": spans})
        print(f"[run] wall {wall:.4f} s, host parse {dec.host_parse_s:.4f}"
              f" s, device spans {spans:.4f} s", flush=True)

    wrappers = {"K1": idct_cuda.dequantize_idct_frames,
                "KL": loopfilter_cuda.loop_filter_plane,
                "KS": mc_cuda.mc_recon}
    before = {k: w.launches for k, w in wrappers.items()}
    dec = BatchDecoder(info, setup)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        dec.decode_clip(data, batch=BATCH)
        torch.cuda.synchronize()
        traced_wall = time.perf_counter() - t0
    stages, kernels = _split(prof.events())
    stage_kernels = _stage_kernels(prof.events())
    lib_launches = {k: w.launches - before[k] for k, w in wrappers.items()}
    sol = speed_of_light(kernels, stage_bounds(
        lambda: BatchDecoder(info, setup).decode_clip(data, batch=BATCH)))
    kernels = sorted(((k, sec, c) for k, (sec, c) in kernels.items()),
                     key=lambda k: -k[1])
    busy = sum(k[1] for k in kernels)
    for name, sec in sorted(stages.items(), key=lambda kv: -kv[1]):
        print(f"[stage] {name}: {sec:.6f} s device", flush=True)
    # K1, KL and KS are launched from their own libraries, outside any
    # PyTorch op, so the profiler does not attribute them to their scopes;
    # list them by name, and their launches by their wrappers' counts.
    print(f"[launches] kernel libraries in the traced pass: {lib_launches}",
          flush=True)
    nf = len(data)
    mc_torch = sum(stage_kernels.get(k, 0)
                   for k in ("theora.mc_recon", "theora.borders"))
    print(f"[launches] theora.mc_recon + theora.borders: {mc_torch} PyTorch "
          f"kernels + {lib_launches['KS']} KS launches = "
          f"{(mc_torch + lib_launches['KS']) / (3 * nf):.2f} per plane per "
          f"frame", flush=True)
    shown = kernels[:15] + [k for k in kernels[15:]
                            if any(w in k[0] for w in (
                                "dequant_idct", "loop_filter", "mc_recon"))]
    for name, sec, count in shown:
        print(f"[kernel] {sec:.6f} s x{count} {name[:100]}", flush=True)
    mid = sorted(r["wall_s"] for r in runs)[len(runs) // 2]
    summary = {
        "card": smi, "frames": nf, "batch": BATCH,
        "median_wall_s": mid, "frames_per_s": nf / mid,
        "mpix_per_s": nf * info.pic_width * info.pic_height * 1.5 / 1e6
        / mid,
        "runs": runs, "traced_wall_s": traced_wall,
        "traced_device_busy_s": busy,
        "traced_idle_share": 1.0 - busy / traced_wall,
        "stages_device_s": stages,
        "library_launches": lib_launches,
        "mc_borders_launches_per_plane_frame":
            (mc_torch + lib_launches["KS"]) / (3 * nf),
        "speed_of_light": sol,
    }
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
