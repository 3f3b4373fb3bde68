"""Generate the 1280x720 test stream hd720_q56_k12.ogv and its per-frame
SHA-256 list.

The first 24 frames of cif_smooth.i420 (352x288 4:2:0) are upscaled
bilinearly to 1280x720 4:2:0, then encoded with the host encoder exactly
as ``python -m theora_tpu.tools.enc -q 56 -k 12`` does. Each line of
hd720_q56_k12.sha256 is the SHA-256 of one decoded frame (Y, then U, then
V, full-frame planes in display orientation, as in the ``.ref.yuv``
goldens) from the host ``Decoder``.

This is a one-off generator, run on the CPU from the repository root:

    python testdata/make_hd720.py

``python testdata/make_hd720.py pp7`` writes hd720_q56_k12_pp7.sha256
instead: the same stream decoded by the host ``Decoder`` at
postprocessing level 7 (pp_list).

It is not part of the PyTorch port and pytest does not collect it.
"""
from __future__ import annotations

import hashlib
import os
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

SRC_W, SRC_H = 352, 288
DST_W, DST_H = 1280, 720
NFRAMES = 24
NAME = "hd720_q56_k12"


def _axis_weights(n_in: int, n_out: int):
    """Pixel-centre-aligned bilinear taps along one axis."""
    x = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    x = np.clip(x, 0, n_in - 1)
    i0 = np.floor(x).astype(np.int64)
    i1 = np.minimum(i0 + 1, n_in - 1)
    return i0, i1, x - i0


def upscale(plane: np.ndarray, h: int, w: int) -> np.ndarray:
    y0, y1, fy = _axis_weights(plane.shape[0], h)
    x0, x1, fx = _axis_weights(plane.shape[1], w)
    p = plane.astype(np.float64)
    rows = p[y0] * (1 - fy)[:, None] + p[y1] * fy[:, None]
    out = rows[:, x0] * (1 - fx) + rows[:, x1] * fx
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def source_frames() -> list[list[np.ndarray]]:
    raw = np.fromfile(os.path.join(HERE, "cif_smooth.i420"), np.uint8)
    ysz, csz = SRC_W * SRC_H, (SRC_W // 2) * (SRC_H // 2)
    frames = []
    for i in range(NFRAMES):
        f = raw[i * (ysz + 2 * csz) : (i + 1) * (ysz + 2 * csz)]
        y = f[:ysz].reshape(SRC_H, SRC_W)
        u = f[ysz : ysz + csz].reshape(SRC_H // 2, SRC_W // 2)
        v = f[ysz + csz :].reshape(SRC_H // 2, SRC_W // 2)
        frames.append([
            upscale(y, DST_H, DST_W),
            upscale(u, DST_H // 2, DST_W // 2),
            upscale(v, DST_H // 2, DST_W // 2),
        ])
    return frames


def main() -> None:
    from theora_tpu.decode.decoder import Decoder
    from theora_tpu.headers import parse_info_header, parse_setup_header
    from theora_tpu.ogg import demux_stream
    from theora_tpu.tools import enc
    from theora_tpu.tools.y4m import write_y4m

    ogv = os.path.join(HERE, f"{NAME}.ogv")
    with tempfile.TemporaryDirectory() as tmp:
        y4m = os.path.join(tmp, "src.y4m")
        write_y4m(y4m, source_frames())
        enc.main(["-q", "56", "-k", "12", y4m, ogv])
    pkts = demux_stream(open(ogv, "rb").read())
    dec = Decoder(parse_info_header(pkts[0].data),
                  parse_setup_header(pkts[2].data))
    lines = []
    for p in pkts[3:]:
        dec.decode_packet(p.data)
        frame = b"".join(np.ascontiguousarray(x).tobytes()
                         for x in dec.ycbcr_out())
        lines.append(hashlib.sha256(frame).hexdigest())
    with open(os.path.join(HERE, f"{NAME}.sha256"), "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"{len(lines)} frames, {os.path.getsize(ogv)} bytes -> {ogv}")


def pp_list(level: int = 7) -> None:
    """hd720_q56_k12_pp<level>.sha256: one SHA-256 per frame of the
    committed stream as the host Decoder gives it at the postprocessing
    level (set_pplevel), the planes as in main()."""
    from theora_tpu.decode.decoder import Decoder
    from theora_tpu.headers import parse_info_header, parse_setup_header
    from theora_tpu.ogg import demux_stream

    pkts = demux_stream(open(os.path.join(HERE, f"{NAME}.ogv"), "rb").read())
    dec = Decoder(parse_info_header(pkts[0].data),
                  parse_setup_header(pkts[2].data))
    dec.set_pplevel(level)
    lines = []
    for p in pkts[3:]:
        dec.decode_packet(p.data)
        frame = b"".join(np.ascontiguousarray(x).tobytes()
                         for x in dec.ycbcr_out())
        lines.append(hashlib.sha256(frame).hexdigest())
    out = os.path.join(HERE, f"{NAME}_pp{level}.sha256")
    with open(out, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"{len(lines)} frames at pp level {level} -> {out}")


if __name__ == "__main__":
    if sys.argv[1:] == ["pp7"]:
        pp_list(7)
    else:
        main()
