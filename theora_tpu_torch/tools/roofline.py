"""Per-stage profile of the device GOP encode on the card, with a
speed-of-light model.

Port of theora_tpu/tools/roofline.py. Each stage of the device encode is
timed apart, on inputs that are on the card before the timing starts:

  me_plan               the ME plan of the GOP's luma (kernel KM,
                        ops/me_cuda.py:plan_with_gold, three launches);
  scan_{luma,cb,cr}_trellis
                        one plane's closed-loop scan (encode/scan.py:
                        encode_plane) with the trellis: per frame step
                        K2 with KS's MC as its head, KT, then K1's fused
                        encode entry;
  scan_luma_rdquant     the luma scan with the R/D quantizer in the
                        trellis' place (KR's fused entry, then K1's);
  pipeline_total        the plan and the three trellis scans;
  transform_core(luma)  pipeline.intra_encode_core on the luma blocks at
                        the qi's intra row (K2, then K1's decode entry).

The inputs are those of bench.py's device pipeline: one GOP of F frames,
frame 0 intra and the others predicted from the previous frame with zero
vectors, no half-pel average, every inter block allowed to skip, one qi
row (48) and its lambdas and loop-filter limit. At qi 48 the limit is 0,
so no frame step launches the loop filter KL.

Timing is JAX's method: one warm call, then R calls dispatched back to
back and closed by one fence, the host clock over R. The fence is
torch.cuda.synchronize() on the card; a CPU run is synchronous. The model
takes JAX's bytes per frame (each frame's planes read as the current
frame and as the two references, the reconstruction written, the int16
coefficients written) over the card's HBM rate (tools/bench_trellis.py:
HBM_BYTES_S, the H100 SXM data sheet's). Scalar lambdas and limits reach
the scan as numpy arrays, as the GOP encoder passes them, and are
uploaded inside each timed call (a few bytes per plane).

Runs on the card unless --device cpu is given; without a card it raises.

Usage: python -m theora_tpu_torch.tools.roofline [--frames N] [--gops G]
           [--size WxH] [--reps R] [--json] [--device D]
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

STAGES = ("me_plan", "scan_luma_trellis", "scan_cb_trellis",
          "scan_cr_trellis", "scan_luma_rdquant", "pipeline_total",
          "transform_core(luma)")
QI = 48


def _synth_frames(w, h, n, seed=11):
    """The JAX tool's frames: a drifting random field over a sine on luma,
    slow sines on chroma, [y, u, v] uint8 planes in display order."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = rng.randint(0, 256, size=(h + 4 * n + 4, w + 2 * n + 4)).astype(
        np.uint8
    )
    frames = []
    for t in range(n):
        y = base[t * 4: t * 4 + h, t * 2: t * 2 + w].copy()
        y = (
            (y.astype(np.int32) + 128 + 80 * np.sin((xx + 8 * t) / 24.0)) // 2
        ).clip(0, 255).astype(np.uint8)
        u = (128 + 50 * np.sin((xx[::2, ::2] + 3 * t) / 40.0)).astype(np.uint8)
        v = (128 + 50 * np.cos((yy[::2, ::2] - 2 * t) / 32.0)).astype(np.uint8)
        frames.append([y, u, v])
    return frames


def _plane_args(enc, frames, F, pli):
    """encode_plane's inputs for one plane of one GOP (G = 1) on
    enc.device, built as GopEncoder.complete_dispatch builds them, with
    the meaning of the JAX tool's _plane_args: the planes in bitstream
    orientation; frame 0 intra, every other frame from the previous one
    with zero vectors, no half-pel average, every block allowed to skip;
    the qi's intra and inter rows (K = 1); the frame lambda, the trellis'
    lambda of each frame's type, the token costs, the R/D quantizer's two
    lambdas and the qi's loop-filter limit. Returns (keyword arguments of
    encode_plane without use_trellis, the plane's fragment count)."""
    from theora_tpu_torch.ops.transforms import rd_lambda

    g = enc.g
    dq = enc.dequant
    qi = enc.qi
    dev = enc.device
    pl = g.planes[pli]
    vpad, hpad = g.plane_padding(pli)
    n = pl.nfrags
    hh, ww = pl.nvfrags * 8, pl.nhfrags * 8
    cur = np.stack([np.asarray(frames[f][pli])[::-1][:hh, :ww]
                    for f in range(F)]).astype(np.uint8)
    inter = np.arange(F) != 0

    def frag(a):
        return torch.from_numpy(np.ascontiguousarray(
            np.broadcast_to(a[:, None], (F, n))[None])).to(dev)

    zeros = np.zeros(F, np.int64)
    deq = np.broadcast_to(dq[qi, pli].astype(np.int16),
                          (1, F, 1, 2, 64)).copy()
    lam_t = np.array([enc._lam_t_for(qi)[int(i)] for i in inter],
                     np.float32)
    lam_q = [rd_lambda(qi, int(dq[qi, pli, t, 1])) * enc.rd_strength
             for t in (0, 1)]
    return {
        "cur_planes": torch.from_numpy(cur[None]).to(dev),
        "frag": {"rs": frag(inter.astype(np.int64)), "o1y": frag(zeros),
                 "o1x": frag(zeros), "o2y": frag(zeros), "o2x": frag(zeros),
                 "u2": frag(np.zeros(F, bool)), "ms": frag(inter)},
        "is_intra": [not i for i in inter],
        "deq": torch.from_numpy(deq).to(dev),
        "limit": np.full((1, F), enc.packer.qinfo["loop_filter_limits"][qi],
                         np.int32),
        "lam": np.full((1, F), rd_lambda(qi, int(dq[qi, 0, 1, 1]))
                       * enc.rd_strength * 4.0, np.float32),
        "nv": pl.nvfrags, "nh": pl.nhfrags, "pad_y": vpad, "pad_x": hpad,
        "lam_t": lam_t.reshape(1, F, 1),
        "nb": enc._nb,
        "lam_q": np.tile(np.array(lam_q, np.float32), (1, F, 1, 1)),
    }, n


def _time(fn, sync, reps):
    """JAX's pipelined timing: a warm call, then reps calls dispatched
    back to back, one fence after the last."""
    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync()
    return (time.perf_counter() - t0) / reps


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--gops", type=int, default=1,
                    help="unused: the JAX tool parses it and never reads "
                         "it; every stage times one GOP of --frames frames")
    ap.add_argument("--size", default="1280x720")
    ap.add_argument("--reps", type=int, default=6)
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain "
                         "versions")
    args = ap.parse_args(argv)

    from theora_tpu_torch import resolve_device
    from theora_tpu_torch.encode.gop import GopEncoder
    from theora_tpu_torch.encode.scan import encode_plane
    from theora_tpu_torch.info import TheoraInfo
    from theora_tpu_torch.ops import me_cuda
    from theora_tpu_torch.pipeline import intra_encode_core
    from theora_tpu_torch.tools.bench_trellis import HBM_BYTES_S

    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    w, h = (int(x) for x in args.size.split("x"))
    F = args.frames
    frames = _synth_frames(w, h, F)
    info = TheoraInfo(frame_width=w, frame_height=h, pic_width=w,
                      pic_height=h, quality=QI)
    enc = GopEncoder(info, qi=QI, device=dev)
    mpix_f = (w * h + 2 * (w // 2) * (h // 2)) / 1e6
    reps = args.reps
    rows = []

    def add(name, dt, mpix):
        rows.append({"stage": name,
                     "ms_per_gop": round(dt * 1e3, 2),
                     "ms_per_frame": round(dt * 1e3 / F, 3),
                     "mpix_s": round(mpix * F / dt, 1)})

    pa = [_plane_args(enc, frames, F, pli)[0] for pli in range(3)]
    ys = pa[0]["cur_planes"][0]
    gold_idx = torch.zeros(F - 1, dtype=torch.int64, device=dev)

    def plan():
        return me_cuda.plan_with_gold(ys, gold_idx)

    add("me_plan", _time(plan, sync, reps), mpix_f)
    for pli, name in ((0, "scan_luma"), (1, "scan_cb"), (2, "scan_cr")):
        add(name + "_trellis", _time(
            lambda a=pa[pli]: encode_plane(**a, use_trellis=True), sync,
            reps), mpix_f)
    add("scan_luma_rdquant", _time(
        lambda: encode_plane(**pa[0], use_trellis=False), sync, reps),
        mpix_f)

    def one_pass():
        plan()
        for a in pa:
            encode_plane(**a, use_trellis=enc.use_trellis)

    add("pipeline_total", _time(one_pass, sync, reps), mpix_f)
    yb = torch.from_numpy(np.stack([
        np.asarray(frames[f][0]).reshape(h // 8, 8, w // 8, 8)
        .transpose(0, 2, 1, 3).reshape(-1, 8, 8) for f in range(F)])).to(dev)
    dq_y = torch.from_numpy(enc.dequant[QI, 0, 0].astype(np.int32)).to(dev)
    add("transform_core(luma)", _time(
        lambda: intra_encode_core(yb, dq_y), sync, reps), w * h / 1e6)

    # Speed of light: JAX's bytes per frame over the card's HBM rate.
    hbm_gbs = HBM_BYTES_S / 1e9
    bytes_frame = (
        1.5 * w * h  # cur u8 (4:2:0)
        + 2 * 1.5 * w * h  # prev + gold refs
        + 1.5 * w * h  # recon write
        + 1.5 * w * h / 64 * 64 * 2  # qdct i16
    )
    sol_us = bytes_frame / (hbm_gbs * 1e3)
    model = {
        "bytes_touched_per_frame_mb": round(bytes_frame / 1e6, 2),
        "hbm_speed_of_light_us_per_frame": round(sol_us, 1),
        "hbm_speed_of_light_mpix_s": round(mpix_f / (sol_us * 1e-6), 0),
    }
    pt = next(r for r in rows if r["stage"] == "pipeline_total")
    model["pipeline_pct_of_hbm_roofline"] = round(
        100.0 * sol_us / (pt["ms_per_frame"] * 1e3), 2)
    card = None
    if on_card:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]

    if args.json:
        print(json.dumps({"stages": rows, "model": model, "card": card}))
    else:
        print(f"card: {card}")
        print(f"{'stage':26s} {'ms/GOP':>9s} {'ms/frame':>9s} {'Mpix/s':>9s}")
        for r in rows:
            print(f"{r['stage']:26s} {r['ms_per_gop']:9.2f}"
                  f" {r['ms_per_frame']:9.3f} {r['mpix_s']:9.1f}")
        print("model:", json.dumps(model))
    return rows, model


if __name__ == "__main__":
    main()
