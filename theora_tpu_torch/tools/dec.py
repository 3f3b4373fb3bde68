"""Decode an Ogg Theora (.ogv) file to .y4m through the batch decoder.

Usage: python -m theora_tpu_torch.tools.dec [--pp N] [--telemetry ...]
       [--batch N] [--device D] in.ogv out.y4m

Counterpart of theora_tpu/tools/dec.py (the dump_video analogue, with its
postprocessing and telemetry ctl usage, examples/dump_video.c:157-213),
decoding with `BatchDecoder.decode_clip` on the card (``--device cuda``,
the default; ``cpu`` runs the plain PyTorch path). --pp sets the
postprocessing level (kernel KP on the card), --telemetry the overlays
drawn on the output frames.
"""
from __future__ import annotations

import argparse
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("--batch", type=int, default=8,
                    help="frames per device batch")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain PyTorch path")
    ap.add_argument("--pp", type=int, default=0,
                    help="postprocessing level 0-7 (deblock/dering)")
    ap.add_argument("--telemetry", default="",
                    help="comma list of overlays: mbmode,mv,qi,bits")
    args = ap.parse_args(argv)

    from theora_tpu_torch.decode.batch import BatchDecoder
    from theora_tpu_torch.headers import (
        parse_comment_header,
        parse_info_header,
        parse_setup_header,
    )
    from theora_tpu_torch.ogg import demux_stream
    from theora_tpu_torch.tools.y4m import write_y4m

    with open(args.input, "rb") as f:
        pkts = demux_stream(f.read())
    info = parse_info_header(pkts[0].data)
    parse_comment_header(pkts[1].data)
    setup = parse_setup_header(pkts[2].data)
    dec = BatchDecoder(info, setup, device=args.device)
    if args.pp:
        dec.set_pplevel(args.pp)
    if args.telemetry:
        dec.set_telemetry(
            **{k.strip(): 1 for k in args.telemetry.split(",") if k.strip()}
        )
    t0 = time.perf_counter()
    outs = dec.decode_clip([p.data for p in pkts[3:]], batch=args.batch)
    dt = time.perf_counter() - t0
    # Crop to the picture region.
    x0, y0 = info.pic_x, info.pic_y
    w, h = info.pic_width, info.pic_height
    hd, vd = info.hdec, info.vdec
    frames = [
        [
            out[0][y0 : y0 + h, x0 : x0 + w],
            out[1][y0 >> vd : (y0 + h) >> vd, x0 >> hd : (x0 + w) >> hd],
            out[2][y0 >> vd : (y0 + h) >> vd, x0 >> hd : (x0 + w) >> hd],
        ]
        for out in outs
    ]
    write_y4m(args.output, frames, (info.fps_numerator, info.fps_denominator))
    mpix = len(frames) * info.pic_width * info.pic_height * 1.5 / 1e6
    print(
        f"{len(frames)} frames decoded in {dt:.2f}s ({mpix / dt:.2f} Mpix/s"
        f" on {dec.device})",
        file=sys.stderr,
    )


if __name__ == "__main__":
    main()
