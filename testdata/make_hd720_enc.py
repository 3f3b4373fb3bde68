"""Generate the packet SHA-256 lists that hold the PyTorch port's device
GOP encoder (theora_tpu_torch.encode.gop.GopEncoder) to the JAX
TpuGopEncoder.

Lists of SHA-256 lines, one per packet (the three headers, then one per
frame; a 2-pass list ends with one more line, the SHA-256 of the pass-1
metrics blob):

- hd720_q48_k8_enc.sha256: 16 frames of make_hd720.source_frames()
  (cif_smooth.i420 upscaled to 1280x720 4:2:0), q48, a keyframe every 8
  frames, clip_batch=8, adaptive_quant=False;
- enc64x48.sha256: moving_frames() at 64x48 for pixel formats 0, 2 and 3
  (5 frames each, keyframe_freq=4, q40, adaptive_quant=False), in that
  order, one block of lines per format;
- hd720_q56_k8_aq_enc.sha256: the same 16 frames at q56, a keyframe every
  8 frames, clip_batch=8, with the JAX encoder's default adaptive_quant
  "auto", which engages the qi triple on every frame at q56;
- mixed96x64_q40_aq_enc.sha256: mixed_frames(), 4 frames of a 96x64 clip
  whose left half is smooth and right half noise, q40, one GOP,
  adaptive_quant=True: the qi triple on every frame (the frames are mixed
  but noise-like, so no activity scales);
- halftex96x64_q48_aq_enc.sha256: halftexture_frames(), the same clip
  with its noise half smoothed into a texture, q48, one GOP, the default
  adaptive_quant "auto": mixed frames that are not noise-like, so the luma
  scan runs with the per-block activity scales.

These five use a fixed qi, the trellis, no target bitrate and no
scene-cut keyframes. The others hold the rest of the encoder's settings:

- enc64x48_sp24.sha256: moving_frames() at 64x48, format 0, 5 frames,
  keyframe_freq=4, q40, set_splevel(2) (the R/D quantizer, one qi per
  frame), then the same at set_splevel(4) (no motion compensation);
- mixed96x64_q40_aq_rd_enc.sha256 and halftex96x64_q48_aq_rd_enc.sha256:
  the two 96x64 clips as above with use_trellis=False: the R/D quantizer
  at three qi rows, with the activity scales in the chooser on the second;
- cut64x48_autokf_enc.sha256: cut_frames(), 14 frames of smooth panning
  content with a scene cut at frame 9, q40, keyframe_freq=8,
  auto_keyframe=True;
- cbr64x48_enc.sha256: moving_frames() at 64x48 (12 frames, seed 13), q40,
  keyframe_freq=4, target_bitrate=60_000, rate_window=1 (the case of
  tests/test_tpu_gop.py:test_single_device_cbr_matches_mesh; the qi
  moves);
- twopass64x48_enc.sha256: the same 12 frames, encode_clip_twopass at
  target_bitrate=60_000 with the whole file as the window, info quality
  0 (no quality floor), encoder qi 40;
- hd720_q48_k8_sp2_enc.sha256: the 16 720p frames at q48, keyframe every
  8, set_splevel(2);
- hd720_2pass_k8_enc.sha256: the 16 720p frames, encode_clip_twopass at
  target_bitrate=2_000_000, buf_delay=16, keyframe every 8, info quality
  0, encoder qi 48.

The JAX encoder runs on the CPU; adaptive_quant (where not the default)
and delta_upload are set as attributes. With use_trellis=False and more
than one qi row the JAX scan passes its per-frame lambda as the
trellis' lambda slots, which that path never reads but indexes by row,
and raises; `_rd_rows_scan_fix` gives those slots [F, K] zeros in this
process (theora_tpu is not edited). Run from the repository root, for
all lists or the named ones:

    python testdata/make_hd720_enc.py [LIST ...]

The q56 "auto" 720p encode (three qi rows per block) took 42.1 s on the
CPU of an 8-core x86 machine, the 96x64 ones about 20 s each (JAX 0.9.0,
compile times included).

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
AQ_QI = 56
MIXED_W, MIXED_H, MIXED_FRAMES, MIXED_QI = 96, 64, 4, 40
HALFTEX_QI = 48
CBR_FRAMES, CBR_SEED, CBR_KF, CBR_QI, CBR_RATE = 12, 13, 4, 40, 60_000
CUT_FRAMES, CUT_AT, CUT_KF = 14, 9, 8
HD_2PASS_RATE, HD_2PASS_BUF = 2_000_000, 16


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


def mixed_frames():
    """The 96x64 clip of tests/test_tpu_gop.py:test_adaptive_quant_device:
    luma smooth on the left half and noise on the right, rolled one
    column a frame; flat U, noise V."""
    rng = np.random.RandomState(9)
    w, h = MIXED_W, MIXED_H
    y0 = np.zeros((h, w), np.uint8)
    y0[:, :w // 2] = 128 + (np.arange(w // 2) // 4)[None, :]
    y0[:, w // 2:] = rng.randint(0, 256, (h, w // 2))
    u0 = np.full((h // 2, w // 2), 90, np.uint8)
    v0 = rng.randint(0, 256, (h // 2, w // 2)).astype(np.uint8)
    return [[np.roll(y0, f, 1), u0, v0] for f in range(MIXED_FRAMES)]


def halftexture_frames():
    """mixed_frames() with the noise half replaced by noise averaged over
    three columns: a texture (lag-1 autocorrelation ~0.67) beside the
    smooth half."""
    rng = np.random.RandomState(10)
    w, h = MIXED_W, MIXED_H
    y0 = np.zeros((h, w), np.uint8)
    y0[:, :w // 2] = 128 + (np.arange(w // 2) // 4)[None, :]
    noise = rng.randint(0, 256, (h, w // 2 + 2))
    y0[:, w // 2:] = (noise[:, :-2] + noise[:, 1:-1] + noise[:, 2:]) // 3
    u0 = np.full((h // 2, w // 2), 90, np.uint8)
    v0 = np.full((h // 2, w // 2), 160, np.uint8)
    return [[np.roll(y0, f, 1), u0, v0] for f in range(MIXED_FRAMES)]


def cut_frames():
    """The 64x48 clip of tests/test_tpu_gop.py:
    test_mesh_arbitrary_rate_window_and_auto_keyframes: smooth panning
    luma over a fixed texture, inverted from frame CUT_AT on (a scene
    cut), with smooth moving chroma."""
    yy, xx = np.mgrid[0:48, 0:64]
    rng = np.random.RandomState(5)
    tex = rng.randint(0, 48, (48, 64)).astype(np.int32)
    frames = []
    for t in range(CUT_FRAMES):
        y = (tex + 80 + 70 * np.sin((xx + 2 * t) / 9.0)).clip(0, 255)
        y = y.astype(np.uint8)
        if t >= CUT_AT:
            y = 255 - y
        u = (128 + 40 * np.cos((yy[::2, ::2] + t) / 7.0)).astype(np.uint8)
        v = (128 - 40 * np.sin((xx[::2, ::2] - t) / 8.0)).astype(np.uint8)
        frames.append([y, u, v])
    return frames


def cbr_frames():
    return moving_frames(64, 48, 0, CBR_FRAMES, CBR_SEED)


def hd_frames():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "make_hd720", os.path.join(HERE, "make_hd720.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.source_frames()[:HD_FRAMES]


def _rd_rows_scan_fix():
    """Give the JAX scan's trellis-lambda slots [F, K] zeros where it
    passes none (use_trellis=False), in this process only."""
    import jax.numpy as jnp

    from theora_tpu.encode import tpu_gop

    if getattr(tpu_gop.make_plane_scan, "rd_rows_fix", False):
        return
    make = tpu_gop.make_plane_scan

    def make_plane_scan(*args, **kwargs):
        scan_fn = make(*args, **kwargs)

        def fixed(*a, **kw):
            if len(a) == 17:  # no nb_* / lam_t_* slots
                a = a + (None, None, jnp.zeros_like(a[15]),
                         jnp.zeros_like(a[16]))
            return scan_fn(*a, **kw)
        return fixed

    make_plane_scan.rd_rows_fix = True
    tpu_gop.make_plane_scan = make_plane_scan


def _jax_encoder(w, h, fmt, qi, adaptive_quant=False, quality=None,
                 splevel=0, use_trellis=True):
    from theora_tpu.encode.tpu_gop import TpuGopEncoder
    from theora_tpu.info import TheoraInfo

    info = TheoraInfo(frame_width=w, frame_height=h, pic_width=w,
                      pic_height=h, quality=qi if quality is None
                      else quality, pixel_fmt=fmt)
    enc = TpuGopEncoder(info, qi=qi, use_trellis=use_trellis)
    enc.adaptive_quant = adaptive_quant
    enc.delta_upload = False
    if splevel:
        enc.set_splevel(splevel)
    if not enc.use_trellis:
        _rd_rows_scan_fix()
    return enc


def _jax_packets(frames, w, h, fmt, qi, kf, adaptive_quant=False, **kw):
    enc = _jax_encoder(w, h, fmt, qi, adaptive_quant, **kw)
    return enc.encode_clip(frames, keyframe_freq=kf, clip_batch=8)


def _twopass(frames, w, h, qi, kf, rate, buf_delay):
    """Packets of encode_clip_twopass, then the blob as one more entry."""
    enc = _jax_encoder(w, h, 0, qi, "auto", quality=0)
    pkts, blob = enc.encode_clip_twopass(frames, keyframe_freq=kf,
                                         target_bitrate=rate,
                                         buf_delay=buf_delay)
    return [p.data for p in pkts] + [blob]


def _write(name, pkts):
    datas = [p if isinstance(p, bytes) else p.data for p in pkts]
    lines = [hashlib.sha256(d).hexdigest() for d in datas]
    with open(os.path.join(HERE, name), "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"{name}: {len(lines)} lines, {sum(map(len, datas))} bytes")


def _small():
    small = []
    for fmt in SMALL_FORMATS:
        frames = moving_frames(64, 48, fmt, SMALL_FRAMES, 11 + fmt)
        small += _jax_packets(frames, 64, 48, fmt, SMALL_QI, SMALL_KF)
    return small


LISTS = {
    "enc64x48.sha256": _small,
    "hd720_q48_k8_enc.sha256": lambda: _jax_packets(
        hd_frames(), 1280, 720, 0, HD_QI, HD_KF),
    "hd720_q56_k8_aq_enc.sha256": lambda: _jax_packets(
        hd_frames(), 1280, 720, 0, AQ_QI, HD_KF, adaptive_quant="auto"),
    "mixed96x64_q40_aq_enc.sha256": lambda: _jax_packets(
        mixed_frames(), MIXED_W, MIXED_H, 0, MIXED_QI, MIXED_FRAMES,
        adaptive_quant=True),
    "halftex96x64_q48_aq_enc.sha256": lambda: _jax_packets(
        halftexture_frames(), MIXED_W, MIXED_H, 0, HALFTEX_QI,
        MIXED_FRAMES, adaptive_quant="auto"),
    "enc64x48_sp24.sha256": lambda: [
        p for lvl in (2, 4) for p in _jax_packets(
            moving_frames(64, 48, 0, SMALL_FRAMES, 11), 64, 48, 0, SMALL_QI,
            SMALL_KF, "auto", splevel=lvl)],
    "mixed96x64_q40_aq_rd_enc.sha256": lambda: _jax_packets(
        mixed_frames(), MIXED_W, MIXED_H, 0, MIXED_QI, MIXED_FRAMES,
        adaptive_quant=True, use_trellis=False),
    "halftex96x64_q48_aq_rd_enc.sha256": lambda: _jax_packets(
        halftexture_frames(), MIXED_W, MIXED_H, 0, HALFTEX_QI,
        MIXED_FRAMES, adaptive_quant="auto", use_trellis=False),
    "cut64x48_autokf_enc.sha256": lambda: _jax_encoder(
        64, 48, 0, SMALL_QI, "auto").encode_clip(
            cut_frames(), keyframe_freq=CUT_KF, auto_keyframe=True),
    "cbr64x48_enc.sha256": lambda: _jax_encoder(
        64, 48, 0, CBR_QI, "auto").encode_clip(
            cbr_frames(), keyframe_freq=CBR_KF, target_bitrate=CBR_RATE,
            rate_window=1),
    "twopass64x48_enc.sha256": lambda: _twopass(
        cbr_frames(), 64, 48, CBR_QI, CBR_KF, CBR_RATE, None),
    "hd720_q48_k8_sp2_enc.sha256": lambda: _jax_packets(
        hd_frames(), 1280, 720, 0, HD_QI, HD_KF, "auto", splevel=2),
    "hd720_2pass_k8_enc.sha256": lambda: _twopass(
        hd_frames(), 1280, 720, HD_QI, HD_KF, HD_2PASS_RATE, HD_2PASS_BUF),
}


def main(names=None) -> None:
    sys.path.insert(0, os.path.dirname(HERE))
    import time

    import jax

    jax.config.update("jax_platforms", "cpu")
    for name in names or LISTS:
        t0 = time.perf_counter()
        _write(name, LISTS[name]())
        print(f"{name}: {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main(sys.argv[1:])
