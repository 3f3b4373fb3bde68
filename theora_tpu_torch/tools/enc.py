"""Encode a .y4m file to Ogg Theora (.ogv) with the device GOP encoder.

Usage: python -m theora_tpu_torch.tools.enc [-q QI] [-k KF] [-z SPEED]
           [-b BITRATE [--two-pass [--two-pass-file F] [--rate-buffer N]]]
           [--adaptive-quant {auto,on,off}] [-j N] [--device D]
           in.y4m out.ogv

Counterpart of ``python -m theora_tpu.tools.enc --device`` (the JAX
TpuGopEncoder) with its device-branch options: the qi (with a bitrate, the
quality floor of the rate controller), the keyframe spacing, speed levels
0-4, CBR (-b), 2-pass (--two-pass with -b, the pass-1 metrics file and the
rate buffer) and adaptive quantization ("auto" by default, as there).
Encodes on the card (``--device cuda``, the default); ``cpu`` runs the
plain PyTorch versions of the kernels.

``-j N`` (JAX ``tools/enc.py:38-40,204-220``) encodes GOP-parallel with N
worker processes through the host Encoder, its closed loop decoded on
the device (parallel/transcode.py), byte-identical to one sequential host
Encoder. Fault of the reference not copied: JAX's -j silently drops -z
and --adaptive-quant (its transcode builds default encoders); here -j
with either set to anything but its default, or with -b, is a usage
error.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def pad_frames(frames, W: int, H: int, pixel_fmt: int):
    """Edge-pad display-orientation frames to multiples of 16, with the
    crop rectangle covering the picture (encode.c:1562-1638). Returns
    (frame width, frame height, padded frames)."""
    fw, fh = (W + 15) & ~15, (H + 15) & ~15
    if (fw, fh) == (W, H):
        return fw, fh, frames
    hd = 0 if pixel_fmt == 3 else 1
    vd = 0 if pixel_fmt >= 2 else 1
    sizes = ((fh, fw), (fh >> vd, fw >> hd), (fh >> vd, fw >> hd))
    return fw, fh, [
        [np.pad(p, ((0, h - p.shape[0]), (0, w - p.shape[1])), mode="edge")
         for p, (h, w) in zip(fr, sizes)]
        for fr in frames
    ]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("-q", "--quality", type=int, default=48)
    ap.add_argument("-k", "--keyframe-freq", type=int, default=64)
    ap.add_argument("-b", "--bitrate", type=int, default=0,
                    help="target bitrate (bps); enables CBR")
    ap.add_argument("--two-pass", action="store_true",
                    help="two-pass rate control (requires --bitrate)")
    ap.add_argument("--two-pass-file", default=None,
                    help="write the OT2P pass-1 metrics file here")
    ap.add_argument("--rate-buffer", type=int, default=0,
                    help="rate buffer size in frames (finite 2-pass "
                         "window; default = whole file)")
    ap.add_argument("-z", "--speed", type=int, default=0,
                    help="speed level 0-4: 0-1 the trellis, 2-3 the R/D "
                         "quantizer, 4 also no motion compensation")
    ap.add_argument("--adaptive-quant", choices=["auto", "on", "off"],
                    nargs="?", const="on", default="auto",
                    help="activity masking: auto (high-qi region, noise-like "
                         "and mixed frames; default), on (every qi the "
                         "spec allows), off; bare --adaptive-quant means "
                         "'on'")
    ap.add_argument("-j", "--workers", type=int, default=0,
                    help="GOP-parallel encode with N worker processes "
                         "through the host encoder (VBR, speed 0, "
                         "adaptive quant auto; byte-identical to "
                         "sequential)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain PyTorch path")
    args = ap.parse_args(argv)
    if args.two_pass and not args.bitrate:
        ap.error("--two-pass requires --bitrate")
    if args.workers and (args.speed or args.adaptive_quant != "auto"
                         or args.bitrate):
        ap.error("-j encodes at speed 0 with adaptive quant 'auto' and no "
                 "target bitrate; it takes no -z, --adaptive-quant or -b")

    from theora_tpu_torch.encode.gop import GopEncoder
    from theora_tpu_torch.info import TheoraInfo
    from theora_tpu_torch.ogg import mux_stream
    from theora_tpu_torch.tools.y4m import read_y4m

    W, H, fps, pixel_fmt, frames = read_y4m(args.input)
    fw, fh, frames = pad_frames(frames, W, H, pixel_fmt)
    info = TheoraInfo(frame_width=fw, frame_height=fh, pic_width=W,
                      pic_height=H, fps_numerator=fps[0],
                      fps_denominator=fps[1], quality=args.quality,
                      target_bitrate=args.bitrate, pixel_fmt=pixel_fmt)
    if args.workers:
        from theora_tpu_torch.parallel.transcode import transcode

        t0 = time.perf_counter()
        pkts = transcode(frames, info, keyframe_freq=args.keyframe_freq,
                         max_workers=args.workers, use_processes=True,
                         device=args.device)
        dt = time.perf_counter() - t0
        with open(args.output, "wb") as f:
            f.write(mux_stream(pkts))
        total = sum(len(p.data) for p in pkts[3:])
        mpix = len(frames) * W * H * 1.5 / 1e6
        print(f"{len(frames)} frames, {total} bytes, {dt:.2f}s "
              f"({mpix / dt:.2f} Mpix/s, {args.workers} workers on "
              f"{args.device})", file=sys.stderr)
        return
    enc = GopEncoder(info, qi=args.quality, device=args.device,
                     adaptive_quant={"auto": "auto", "on": True,
                                     "off": False}[args.adaptive_quant])
    if args.speed:
        enc.set_splevel(args.speed)
    t0 = time.perf_counter()
    if args.two_pass:
        pkts, blob = enc.encode_clip_twopass(
            frames, keyframe_freq=args.keyframe_freq,
            target_bitrate=args.bitrate,
            buf_delay=args.rate_buffer or None)
        if args.two_pass_file:
            with open(args.two_pass_file, "wb") as f:
                f.write(blob)
    else:
        pkts = enc.encode_clip(frames, keyframe_freq=args.keyframe_freq,
                               target_bitrate=args.bitrate)
    dt = time.perf_counter() - t0
    with open(args.output, "wb") as f:
        f.write(mux_stream(pkts))
    total = sum(len(p.data) for p in pkts[3:])
    mpix = len(frames) * W * H * 1.5 / 1e6
    print(f"{len(frames)} frames, {total} bytes, {dt:.2f}s "
          f"({mpix / dt:.2f} Mpix/s on {enc.device})", file=sys.stderr)


if __name__ == "__main__":
    main()
