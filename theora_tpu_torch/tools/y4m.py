"""YUV4MPEG2 (.y4m) writer; copy of `write_y4m` in theora_tpu/tools/y4m.py."""
from __future__ import annotations

import numpy as np


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
