"""Record a torch.profiler trace of the codec's device pipeline.

Port of theora_tpu/tools/profile.py: one warm GopEncoder.encode_gop pass
(--mode encode) or one warm BatchDecoder batch (--mode decode) on
--device (the card unless ``--device cpu``), recorded with CPU and, on
the card, CUDA activity. The codec's stages carry record_function labels
(``theora.enc.*`` in encode/gop.py and encode/scan.py, ``theora.*`` in
decode/batch.py), so the trace groups the work by codec stage. It is
written as a Chrome trace, DIR/trace.json: open it in Perfetto
(ui.perfetto.dev) or chrome://tracing.

Usage: python -m theora_tpu_torch.tools.profile [--mode encode|decode]
           [--out DIR] [--frames N] [--size WxH] [--device D]
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def _synth_frames(w, h, n):
    rng = np.random.RandomState(7)
    base = rng.randint(0, 256, size=(h + 64, w + 64)).astype(np.uint8)
    out = []
    for t in range(n):
        y = base[t * 2 : t * 2 + h, t : t + w]
        u = np.full((h // 2, w // 2), 90 + 3 * t, np.uint8)
        v = np.full((h // 2, w // 2), 160 - 2 * t, np.uint8)
        out.append([y, u, v])
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--mode", choices=("encode", "decode"),
                    default="encode")
    ap.add_argument("--out", default="theora_trace",
                    help="directory of the trace (trace.json)")
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--size", default="640x352")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain PyTorch path")
    args = ap.parse_args(argv)

    from theora_tpu_torch import resolve_device
    from theora_tpu_torch.decode.batch import BatchDecoder
    from theora_tpu_torch.encode.gop import GopEncoder
    from theora_tpu_torch.headers import parse_info_header, \
        parse_setup_header
    from theora_tpu_torch.info import TheoraInfo
    from theora_tpu_torch.tools.profile_encode import traced

    device = resolve_device(args.device)
    w, h = (int(x) for x in args.size.split("x"))
    frames = _synth_frames(w, h, args.frames)
    info = TheoraInfo(frame_width=w, frame_height=h,
                      pic_width=w, pic_height=h, quality=48)
    enc = GopEncoder(info, qi=48, device=device)
    # Warm up outside the trace so the kernels' builds and first launches
    # do not drown the steps.
    enc.encode_gop(frames)
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "trace.json")
    if args.mode == "encode":
        traced(lambda: enc.encode_gop(frames), device, path)
    else:
        pkts = enc.encode_clip(frames, keyframe_freq=args.frames)
        dinfo = parse_info_header(pkts[0].data)
        setup = parse_setup_header(pkts[2].data)
        datas = [p.data for p in pkts[3:]]
        BatchDecoder(dinfo, setup, device).decode_batch(datas)  # warm
        dec = BatchDecoder(dinfo, setup, device)
        traced(lambda: dec.decode_batch(datas), device, path)
    print(f"trace written to {path}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
