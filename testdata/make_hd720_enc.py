"""Generate the packet SHA-256 lists that hold the PyTorch port's device
GOP encoder (theora_tpu_torch.encode.gop.GopEncoder) to the JAX
TpuGopEncoder.

Two lists, each line the SHA-256 of one packet (the three headers, then
one line per frame):

- hd720_q48_k8_enc.sha256: 16 frames of make_hd720.source_frames()
  (cif_smooth.i420 upscaled to 1280x720 4:2:0), q48, a keyframe every 8
  frames, clip_batch=8;
- enc64x48.sha256: moving_frames() at 64x48 for pixel formats 0, 2 and 3
  (5 frames each, keyframe_freq=4, q40), in that order, one block of
  lines per format.

Both use the configuration the port supports: fixed qi, the trellis,
adaptive_quant=False, no target bitrate, no scene-cut keyframes. The JAX
encoder runs on the CPU; adaptive_quant and delta_upload are set as
attributes. Run from the repository root (the 720p encode takes a few
minutes):

    python testdata/make_hd720_enc.py

It is not part of the port and pytest does not collect it;
chip_smoke.py loads moving_frames() and make_hd720.source_frames() from
here by path.
"""
from __future__ import annotations

import hashlib
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

HD_FRAMES = 16
HD_QI = 48
HD_KF = 8
SMALL_FORMATS = (0, 2, 3)
SMALL_FRAMES = 5
SMALL_KF = 4
SMALL_QI = 40


def moving_frames(w: int, h: int, fmt: int, n: int, seed: int):
    """Random planes rolled a little each frame: every block moves, so
    the ME, the MV modes and the skip test all run."""
    rng = np.random.RandomState(seed)
    cw = w if fmt & 1 else w // 2
    ch = h if fmt & 2 else h // 2
    y0 = rng.randint(0, 256, (h, w)).astype(np.uint8)
    u0 = rng.randint(0, 256, (ch, cw)).astype(np.uint8)
    v0 = rng.randint(0, 256, (ch, cw)).astype(np.uint8)
    return [
        [np.roll(y0, (f, 2 * f), (0, 1)),
         np.roll(u0, (f // 2, f), (0, 1)),
         np.roll(v0, (f // 2, f), (0, 1))]
        for f in range(n)
    ]


def hd_frames():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "make_hd720", os.path.join(HERE, "make_hd720.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.source_frames()[:HD_FRAMES]


def _jax_packets(frames, w, h, fmt, qi, kf):
    from theora_tpu.encode.tpu_gop import TpuGopEncoder
    from theora_tpu.info import TheoraInfo

    info = TheoraInfo(frame_width=w, frame_height=h, pic_width=w,
                      pic_height=h, quality=qi, pixel_fmt=fmt)
    enc = TpuGopEncoder(info, qi=qi)
    enc.adaptive_quant = False
    enc.delta_upload = False
    return enc.encode_clip(frames, keyframe_freq=kf, clip_batch=8)


def _write(name, pkts):
    lines = [hashlib.sha256(p.data).hexdigest() for p in pkts]
    with open(os.path.join(HERE, name), "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"{name}: {len(lines)} packets, "
          f"{sum(len(p.data) for p in pkts)} bytes")


def main() -> None:
    sys.path.insert(0, os.path.dirname(HERE))
    import jax

    jax.config.update("jax_platforms", "cpu")
    small = []
    for fmt in SMALL_FORMATS:
        frames = moving_frames(64, 48, fmt, SMALL_FRAMES, 11 + fmt)
        small += _jax_packets(frames, 64, 48, fmt, SMALL_QI, SMALL_KF)
    _write("enc64x48.sha256", small)
    _write("hd720_q48_k8_enc.sha256",
           _jax_packets(hd_frames(), 1280, 720, 0, HD_QI, HD_KF))


if __name__ == "__main__":
    main()
