"""Print library and stream information (the libtheora_info analogue).

Port of theora_tpu/tools/info.py over the port's info, headers and Ogg
modules: the first line names theora_tpu_torch, every other line is the
JAX tool's. It decodes nothing, so it takes no device.

Usage: python -m theora_tpu_torch.tools.info [in.ogv]
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("input", nargs="?", help="optional .ogv to inspect")
    args = ap.parse_args(argv)

    from theora_tpu_torch import __version__
    from theora_tpu_torch.info import (
        VENDOR_STRING, VERSION_MAJOR, VERSION_MINOR, VERSION_SUBMINOR,
    )

    print(f"theora_tpu_torch {__version__} ({VENDOR_STRING})")
    print(
        f"bitstream version: {VERSION_MAJOR}.{VERSION_MINOR}."
        f"{VERSION_SUBMINOR}"
    )
    if args.input:
        from theora_tpu_torch.headers import (
            parse_comment_header, parse_info_header,
        )
        from theora_tpu_torch.ogg import demux_stream

        with open(args.input, "rb") as f:
            pkts = demux_stream(f.read())
        info = parse_info_header(pkts[0].data)
        c = parse_comment_header(pkts[1].data)
        print(f"frame: {info.frame_width}x{info.frame_height}")
        print(
            f"picture: {info.pic_width}x{info.pic_height}"
            f"+{info.pic_x}+{info.pic_y}"
        )
        print(f"fps: {info.fps_numerator}/{info.fps_denominator}")
        print(f"pixel format: {int(info.pixel_fmt)}")
        print(f"vendor: {c['vendor'].decode('utf-8', 'replace')}")
        print(f"packets: {len(pkts) - 3} data")
    return 0


if __name__ == "__main__":
    sys.exit(main())
