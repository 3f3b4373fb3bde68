"""Image-sequence encoder: PNG/TIFF/JPEG frames -> Ogg Theora.

The png2theora/tiff2theora analogue (examples/png2theora.c:1-942,
examples/tiff2theora.c) generalized over every format PIL reads. RGB
inputs are converted with the same BT.601 full->video-range math the
reference uses (png2theora.c rgb_to_yuv) and 4:2:0 subsampled.

Port of theora_tpu/tools/img2theora.py: the port's host Encoder, its
closed loop decoded on --device (the card unless ``--device cpu``).

Usage: python -m theora_tpu_torch.tools.img2theora [-q Q] [-k KF] [-f FPS]
       [--device D] 'frames/*.png' out.ogv
"""
from __future__ import annotations

import argparse
import glob
import sys

import numpy as np


def rgb_to_ycbcr420(img: np.ndarray):
    """RGB uint8 [H, W, 3] -> video-range Y'CbCr 4:2:0 planes
    (png2theora.c:268-318 math)."""
    r = img[..., 0].astype(np.int32)
    g = img[..., 1].astype(np.int32)
    b = img[..., 2].astype(np.int32)
    y = (65481 * r + 128553 * g + 24966 * b + 4207500) // 255000
    # Subsample chroma by box averaging before the transform (on RGB),
    # matching the reference's 2x2 averaging of the source pixels.
    H, W = r.shape
    r2 = r.reshape(H // 2, 2, W // 2, 2).mean(axis=(1, 3))
    g2 = g.reshape(H // 2, 2, W // 2, 2).mean(axis=(1, 3))
    b2 = b.reshape(H // 2, 2, W // 2, 2).mean(axis=(1, 3))
    cb = (-33488 * r2 - 65744 * g2 + 99232 * b2 + 29032005) / 225930
    cr = (157024 * r2 - 131488 * g2 - 25536 * b2 + 21612201) / 178755
    return (
        np.clip(y, 0, 255).astype(np.uint8),
        np.clip(cb, 0, 255).astype(np.uint8),
        np.clip(cr, 0, 255).astype(np.uint8),
    )


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("pattern", help="glob of input images (sorted)")
    ap.add_argument("output")
    ap.add_argument("-q", "--quality", type=int, default=48)
    ap.add_argument("-k", "--keyframe-freq", type=int, default=64)
    ap.add_argument("-f", "--fps", type=int, default=24)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the encoder's closed loop; "
                         "'cpu' for the CPU")
    args = ap.parse_args(argv)

    from PIL import Image

    from theora_tpu_torch import resolve_device
    from theora_tpu_torch.encode.encoder import Encoder
    from theora_tpu_torch.info import TheoraInfo
    from theora_tpu_torch.ogg import mux_stream

    device = resolve_device(args.device)

    paths = sorted(glob.glob(args.pattern))
    if not paths:
        print(f"no images match {args.pattern!r}", file=sys.stderr)
        return 1
    first = np.asarray(Image.open(paths[0]).convert("RGB"))
    ph, pw = first.shape[:2]
    fw, fh = (pw + 15) & ~15, (ph + 15) & ~15
    info = TheoraInfo(
        frame_width=fw, frame_height=fh, pic_width=pw, pic_height=ph,
        pic_x=0, pic_y=0, fps_numerator=args.fps, fps_denominator=1,
        quality=args.quality, keyframe_granule_shift=6,
    )
    enc = Encoder(info, device=device)
    enc.keyframe_freq = args.keyframe_freq
    pkts = enc.flush_headers()
    for i, p in enumerate(paths):
        img = np.asarray(Image.open(p).convert("RGB"))
        if img.shape[:2] != (ph, pw):
            print(f"{p}: size mismatch", file=sys.stderr)
            return 1
        # Pad to frame size by edge replication (encode.c:1562-1638).
        img = np.pad(img, ((0, fh - ph), (0, fw - pw), (0, 0)), mode="edge")
        y, cb, cr = rgb_to_ycbcr420(img)
        pkts.append(
            enc.encode_frame([y, cb, cr], e_o_s=(i == len(paths) - 1))
        )
    with open(args.output, "wb") as f:
        f.write(mux_stream(pkts))
    print(f"{len(paths)} frames -> {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
