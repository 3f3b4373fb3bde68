"""YUV4MPEG2 (.y4m) reader and writer; copy of theora_tpu/tools/y4m.py."""
from __future__ import annotations

import numpy as np


def read_y4m(path: str):
    """Returns (width, height, fps (num, den), pixel_fmt, frames): frames
    a list of [y, u, v] uint8 planes, display orientation; pixel_fmt the
    Theora format (0 4:2:0, 2 4:2:2, 3 4:4:4) of the C tag."""
    with open(path, "rb") as f:
        header = f.readline().decode("ascii", "replace").strip()
        if not header.startswith("YUV4MPEG2"):
            raise ValueError("not a y4m file")
        W = H = 0
        fps = (30, 1)
        fmt = "420"
        for tok in header.split()[1:]:
            if tok[0] == "W":
                W = int(tok[1:])
            elif tok[0] == "H":
                H = int(tok[1:])
            elif tok[0] == "F":
                n, d = tok[1:].split(":")
                fps = (int(n), int(d))
            elif tok[0] == "C":
                fmt = tok[1:]
        if fmt.startswith("420"):
            cw, ch, pixel_fmt = W // 2, H // 2, 0
        elif fmt.startswith("422"):
            cw, ch, pixel_fmt = W // 2, H, 2
        elif fmt.startswith("444"):
            cw, ch, pixel_fmt = W, H, 3
        else:
            raise NotImplementedError(f"y4m chroma format {fmt}")
        frames = []
        ysz, csz = W * H, cw * ch
        while True:
            line = f.readline()
            if not line:
                break
            if not line.startswith(b"FRAME"):
                raise ValueError("bad y4m frame marker")
            data = f.read(ysz + 2 * csz)
            if len(data) < ysz + 2 * csz:
                break
            frames.append([
                np.frombuffer(data[:ysz], np.uint8).reshape(H, W),
                np.frombuffer(data[ysz:ysz + csz], np.uint8).reshape(ch, cw),
                np.frombuffer(data[ysz + csz:], np.uint8).reshape(ch, cw),
            ])
    return W, H, fps, pixel_fmt, frames


def write_y4m(path: str, frames, fps=(30, 1)) -> None:
    """frames: list of [y, u, v] uint8 planes, display orientation."""
    H, W = frames[0][0].shape
    ch, cw = frames[0][1].shape
    tag = "C420jpeg" if (cw, ch) == (W // 2, H // 2) else (
        "C422" if (cw, ch) == (W // 2, H) else "C444"
    )
    with open(path, "wb") as f:
        f.write(
            f"YUV4MPEG2 W{W} H{H} F{fps[0]}:{fps[1]} Ip A1:1 {tag}\n".encode()
        )
        for y, u, v in frames:
            f.write(b"FRAME\n")
            f.write(np.ascontiguousarray(y).tobytes())
            f.write(np.ascontiguousarray(u).tobytes())
            f.write(np.ascontiguousarray(v).tobytes())
