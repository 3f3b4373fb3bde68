"""Encode a .y4m file to Ogg Theora (.ogv) with the device GOP encoder.

Usage: python -m theora_tpu_torch.tools.enc [-q QI] [-k KF]
           [--adaptive-quant {auto,on,off}] [--device D] in.y4m out.ogv

Counterpart of ``python -m theora_tpu.tools.enc --device`` (the JAX
TpuGopEncoder) for the configuration the port carries: a fixed qi, the
trellis, adaptive quantization ("auto" by default, as there), no rate
control, keyframes every KF frames. Encodes on the card (``--device
cuda``, the default); ``cpu`` runs the plain PyTorch versions of the
kernels.
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
    ap.add_argument("--adaptive-quant", choices=["auto", "on", "off"],
                    nargs="?", const="on", default="auto",
                    help="activity masking: auto (high-qi region, noise-like "
                         "and mixed frames; default), on (every qi the "
                         "spec allows), off; bare --adaptive-quant means "
                         "'on'")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain PyTorch path")
    args = ap.parse_args(argv)

    from theora_tpu_torch.encode.gop import GopEncoder
    from theora_tpu_torch.info import TheoraInfo
    from theora_tpu_torch.ogg import mux_stream
    from theora_tpu_torch.tools.y4m import read_y4m

    W, H, fps, pixel_fmt, frames = read_y4m(args.input)
    fw, fh, frames = pad_frames(frames, W, H, pixel_fmt)
    info = TheoraInfo(frame_width=fw, frame_height=fh, pic_width=W,
                      pic_height=H, fps_numerator=fps[0],
                      fps_denominator=fps[1], quality=args.quality,
                      pixel_fmt=pixel_fmt)
    enc = GopEncoder(info, qi=args.quality, device=args.device,
                     adaptive_quant={"auto": "auto", "on": True,
                                     "off": False}[args.adaptive_quant])
    t0 = time.perf_counter()
    pkts = enc.encode_clip(frames, keyframe_freq=args.keyframe_freq)
    dt = time.perf_counter() - t0
    with open(args.output, "wb") as f:
        f.write(mux_stream(pkts))
    total = sum(len(p.data) for p in pkts[3:])
    mpix = len(frames) * W * H * 1.5 / 1e6
    print(f"{len(frames)} frames, {total} bytes, {dt:.2f}s "
          f"({mpix / dt:.2f} Mpix/s on {enc.device})", file=sys.stderr)


if __name__ == "__main__":
    main()
