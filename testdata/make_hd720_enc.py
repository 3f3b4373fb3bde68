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

Four hold the device-resident transcode (decode batches of
keyframe_freq packets feeding the encoder's stages), with the input
stream's own info and the encoder's defaults (adaptive_quant "auto"):

- transcode64x48_k6_enc.sha256: clip64x48_k8_q20.tpkt's 8 data packets,
  keyframe_freq=6, qi=40, by JAX transcode_device;
- transcode64x48_dup_enc.sha256: dup_packets() of the same packets
  (keyframe_freq=4: a dup in mid-batch, a dup leading the second batch,
  a batch of dups only), qi=40. JAX transcode_device gives a dup that
  leads a batch (emit index -1) that batch's last live frame, a future
  frame, against the contract of its own docstring (byte-identical to
  host decode + encode_clip); this list is made by that contract, the
  JAX host Decoder and TpuGopEncoder.encode_clip;
- transcode64x48_cbr_enc.sha256: the 8 packets, qi=40, keyframe_freq=2
  (4 GOPs), target_bitrate=60_000, rate_window=1 (the qi moves), by JAX
  transcode_device;
- hd720_transcode_q48_k8_enc.sha256: hd720_q56_k12.ogv's 24 data
  packets, keyframe_freq=8, qi=48, by JAX transcode_device (chip_smoke.py
  only).

Five hold the mesh GOP encoder (JAX theora_tpu.parallel.gop on the CPU's
8-device virtual mesh, as tests/conftest.py sets it up; the port runs the
gop axis as a batch dimension on one card, theora_tpu_torch.parallel.gop):

- mesh64x48_vbr_enc.sha256: moving_frames(64, 48, 0, 11, 7), encode_clip_mesh
  at keyframe_freq=4, qi=40 on make_mesh(8, frag_axis=2) (gop axis 4; the
  last GOP is 3 frames, padded);
- mesh64x48_cut_cbr_enc.sha256: cut_frames(), keyframe_freq=8, qi=40,
  target_bitrate=90_000, rate_window=3, auto_keyframe=True on make_mesh(4)
  (gop axis 4): the window does not divide the axis and the GOPs are
  uneven (8, 1 and 5 frames);
- mesh64x48_twopass_enc.sha256: the 11 frames at info quality 0, pass 1 by
  TpuGopEncoder(qi=40).encode_clip_pass1(keyframe_freq=4,
  target_bitrate=120_000), then encode_clip_mesh with that blob,
  rate_window=2, buf_delay=16 on make_mesh(8, frag_axis=2); the pass-1
  blob's SHA-256 is the last line;
- mesh96x64_sp2_enc.sha256: mixed_frames() at q40 "auto" through
  MeshGopEncoder(make_mesh(2)) with base.set_splevel(2) (the R/D
  quantizer, one qi per frame): encode_gops of the two 2-frame GOPs in one
  batch, headers first;
- mesh96x64_halftex_q48_enc.sha256: halftexture_frames() at q48 (the
  default adaptive_quant "auto"), encode_clip_mesh at keyframe_freq=2 on
  make_mesh(2): the qi triple with the per-block lambda scales on both
  GOPs of one batch (mixed_frames() at speed 0 is noise-like, so it never
  reaches the scales).

Four hold the all-keyframe batch encoder
(theora_tpu_torch.encode.intra.BatchIntraEncoder), made by the JAX host
Encoder at keyframe_freq=1, each case also CHECKED against the JAX
TpuBatchIntraEncoder except F5's (the generator raises where they
differ); INTRA_CASES names each case's frames and settings:

- intra64x48_enc.sha256: the 64x48 cases of INTRA_SMALL in that order,
  headers and 6 packets each: clip64x48_frames() at q40 and q60 (the
  intra triple [60, 50, 63]), adaptive_quant False at q60 and True at
  q40, speed levels 2 (q40) and 3 (q60), and moving_frames() in pixel
  formats 2 and 3 at q40;
- intra96x64_aq_enc.sha256: mixed_frames() at q40 "auto" (noise-like
  and mixed: the triple, the chooser at a quarter lambda, per-block
  scales) and halftexture_frames() at q48 "auto" (the mixed window);
- intra64x48_f5_enc.sha256: clip64x48_frames() at q40 with
  target_bitrate=200_000, the host Encoder only: JAX's batch quantizes
  every frame at the batch's first qi (fault F5) and differs on frames
  1-4;
- hd720_intra_q48_enc.sha256: the 16 720p frames at q48 (one qi on every
  frame, so every frame takes the device's fDCT + quantization),
  chip_smoke.py only.

Three hold the host Encoder's inter path with its closed loop on the
card (theora_tpu_torch.encode.encoder.Encoder, and through it
theora_tpu_torch.parallel's GOP-parallel transcodes), made by the JAX
host Encoder at each case's keyframe spacing; HOST_CASES names each
case's frames and settings. Where a case runs at the JAX Encoder's
defaults, JAX's parallel transcode over threads (max_workers=4) and over
processes (max_workers=2) must give the same list (the generator raises
where they differ):

- host64x48_enc.sha256: the 64x48 cases of HOST_SMALL in that order,
  headers and packets each: clip64x48_frames(8) at a keyframe every 4, at
  q40 (the loop filter runs in the closed loop), q48 and q60 (where
  "auto" engages the inter qi triple), adaptive_quant True at q40 and
  False at q48, speed levels 1-4 at q40 (speed 4 fires the auto-keyframe
  retry); moving_frames() in pixel formats 2 and 3 at q40, a keyframe
  every 3; scene_cut_frames() at q40, keyframe_freq 64, where the retry
  fires at two of its three cuts;
- host96x64_aq_enc.sha256: mixed_frames() at q40 and halftexture_frames()
  at q48, "auto", one GOP (per-block lambda scales on inter frames);
- hd720_host_q48_k8_enc.sha256: the 16 720p frames at q48 "auto", a
  keyframe every 8, chip_smoke.py only.

cut_frames() is not among them: its inverted frame codes smaller than
the keyframe at every qi, so the retry never fires there.

Two packet records hold the port's CPU tests to the JAX TpuGopEncoder
without a JAX encode in the test run (PKT_RECORDS): one line per packet,
"<case> <SHA-256> <granulepos> <packetno> <b_o_s> <e_o_s>" (flags 0 or
1), the three headers first:

- enc64x48_cases.pkts: tests/test_torch_encode.py's cases, ENC_CASES
  (moving_frames() in pixel formats 0, 2 and 3 at q40 and
  clip64x48_frames(8) at q32, a keyframe every 4), by TpuGopEncoder with
  adaptive_quant False as an attribute, clip_batch=8;
- aq_cases.pkts: tests/test_torch_adaptive.py's cases, AQ_CASES
  (_jax_packets at adaptive_quant "auto" or True: the q56 triple on
  moving frames, the 96x64 mixed clip at True, noise_frames() at q24,
  smooth_frames() at q36, the 96x64 half-texture clip at q48), and that
  half-texture case again as TpuGopEncoder(rd_strength=rd) with
  delta_upload False at rd 3.0 and 1.5 (cases "rd3.0", "rd1.5").

cli_cases.sha256 holds the JAX encoder CLI's output for the CLI tests of
tests/test_torch_encode.py and tests/test_torch_adaptive.py, one line
"<case> <SHA-256 of the .ogv>" per CLI_CASES case: `python -m
theora_tpu.tools.enc --device FLAGS in.y4m out.ogv` on the case's frames
cropped to a 60x44 picture (an edge-padded frame and a crop rectangle),
written by theora_tpu_torch.tools.y4m.write_y4m as the tests write them:
clip64x48_frames(8) and its first frame again at -q 36 -k 8 with
adaptive quantization off (9 frames end on a one-frame chunk), and
noise_frames(5) at the CLI's defaults.

The 720p mesh is checked against the sequential lists (CHECKS): JAX's
encode_clip_mesh of hd_frames() at q56 "auto", keyframe every 8, on
make_mesh(2), and MeshGopEncoder(make_mesh(2)) at q48 with
base.set_splevel(2), encode_gops of the two 8-frame GOPs in one batch.
Where JAX's mesh gives the sequential list's hashes, no mesh list is
written and chip_smoke.py holds the port's mesh at gop axis 2 to the
sequential list; where it does not, hd720_mesh_q56_k8_enc.sha256 or
hd720_mesh_q48_k8_sp2_enc.sha256 is written. Both matched (JAX 0.9.0 on
the CPU of an 8-core x86 machine, 59.0 s and 18.9 s), so neither file
exists.

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
TC_SOURCE, TC_KF, TC_QI, TC_DUP_KF = "clip64x48_k8_q20.tpkt", 6, 40, 4
TC_CBR_KF, TC_CBR_RATE = 2, 60_000
HD_TC_SOURCE, HD_TC_KF, HD_TC_QI = "hd720_q56_k12.ogv", 8, 48
INTRA_FRAMES, HD_INTRA_QI = 6, 48
MESH_FRAMES, MESH_SEED, MESH_CBR_RATE, MESH_2PASS_RATE = 11, 7, 90_000, \
    120_000


def dup_packets(datas):
    """8 data packets with dup (0-byte) packets inserted so that, in
    batches of TC_DUP_KF, the first batch holds a dup in mid-batch, the
    second leads with a dup and the third holds dups only."""
    d = list(datas)
    return d[0:2] + [b""] + d[2:3] + [b""] + d[3:6] + [b""] * 4 + d[6:8]


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


def noise_frames(n: int):
    """n 64x48 4:2:0 frames of uniform noise (seed 47): the noise gate."""
    rng = np.random.default_rng(47)
    return [[rng.integers(0, 256, s).astype(np.uint8)
             for s in ((48, 64), (24, 32), (24, 32))] for _ in range(n)]


def smooth_frames(n: int):
    """n 64x48 4:2:0 frames of smooth ramps moving two pixels a frame:
    no adaptive-quantization gate engages."""
    yy, xx = np.indices((48, 64))
    return [[((xx + 2 * f) * 2 + yy).astype(np.uint8),
             np.full((24, 32), 100 + f, np.uint8),
             ((np.indices((24, 32))[1] + f) * 3).astype(np.uint8)]
            for f in range(n)]


def clip64x48_frames(n: int = INTRA_FRAMES):
    """The first n frames of testdata/clip64x48.i420 (4:2:0)."""
    raw = np.fromfile(os.path.join(HERE, "clip64x48.i420"), np.uint8)
    w, h = 64, 48
    fs = w * h * 3 // 2
    out = []
    for i in range(n):
        f = raw[i * fs:(i + 1) * fs]
        out.append([f[:w * h].reshape(h, w),
                    f[w * h:w * h * 5 // 4].reshape(h // 2, w // 2),
                    f[w * h * 5 // 4:].reshape(h // 2, w // 2)])
    return out


# The batch intra encoder's cases: name -> (frames, width, height, pixel
# format, qi, adaptive_quant, speed level).
INTRA_CASES = {
    "q40": ("clip", 64, 48, 0, 40, "auto", 0),
    "q60": ("clip", 64, 48, 0, 60, "auto", 0),
    "aq_off_q60": ("clip", 64, 48, 0, 60, False, 0),
    "aq_on_q40": ("clip", 64, 48, 0, 40, True, 0),
    "sp2_q40": ("clip", 64, 48, 0, 40, "auto", 2),
    "sp3_q60": ("clip", 64, 48, 0, 60, "auto", 3),
    "fmt2_q40": ("moving2", 64, 48, 2, 40, "auto", 0),
    "fmt3_q40": ("moving3", 64, 48, 3, 40, "auto", 0),
    "mixed_q40": ("mixed", 96, 64, 0, 40, "auto", 0),
    "halftex_q48": ("halftex", 96, 64, 0, 48, "auto", 0),
    "hd720_q48": ("hd", 1280, 720, 0, HD_INTRA_QI, "auto", 0),
}
INTRA_SMALL = ("q40", "q60", "aq_off_q60", "aq_on_q40", "sp2_q40",
               "sp3_q60", "fmt2_q40", "fmt3_q40")
INTRA_AQ = ("mixed_q40", "halftex_q48")
F5_CASE, F5_RATE = "q40", 200_000


def intra_frames(kind: str):
    if kind == "clip":
        return clip64x48_frames()
    if kind.startswith("moving"):
        fmt = int(kind[-1])
        return moving_frames(64, 48, fmt, INTRA_FRAMES, 11 + fmt)
    return {"mixed": mixed_frames, "halftex": halftexture_frames,
            "hd": hd_frames}[kind]()


# The host Encoder's cases: name -> (frames, width, height, pixel format,
# qi, adaptive_quant, speed level, keyframe_freq).
HOST_CASES = {
    "q40": ("clip8", 64, 48, 0, 40, "auto", 0, 4),
    "q48": ("clip8", 64, 48, 0, 48, "auto", 0, 4),
    "q60": ("clip8", 64, 48, 0, 60, "auto", 0, 4),
    "aq_on_q40": ("clip8", 64, 48, 0, 40, True, 0, 4),
    "aq_off_q48": ("clip8", 64, 48, 0, 48, False, 0, 4),
    "sp1_q40": ("clip8", 64, 48, 0, 40, "auto", 1, 4),
    "sp2_q40": ("clip8", 64, 48, 0, 40, "auto", 2, 4),
    "sp3_q40": ("clip8", 64, 48, 0, 40, "auto", 3, 4),
    "sp4_q40": ("clip8", 64, 48, 0, 40, "auto", 4, 4),
    "fmt2_q40": ("moving2", 64, 48, 2, 40, "auto", 0, 3),
    "fmt3_q40": ("moving3", 64, 48, 3, 40, "auto", 0, 3),
    "cut_q40": ("scenecut", 64, 48, 0, 40, "auto", 0, 64),
    "mixed_q40": ("mixed", 96, 64, 0, 40, "auto", 0, 4),
    "halftex_q48": ("halftex", 96, 64, 0, 48, "auto", 0, 4),
    "hd720_q48": ("hd", 1280, 720, 0, HD_QI, "auto", 0, HD_KF),
}
HOST_SMALL = ("q40", "q48", "q60", "aq_on_q40", "aq_off_q48", "sp1_q40",
              "sp2_q40", "sp3_q40", "sp4_q40", "fmt2_q40", "fmt3_q40",
              "cut_q40")
HOST_AQ = ("mixed_q40", "halftex_q48")
SCENE_CUTS, SCENE_FRAMES = (0, 5, 8, 14), 18


def host_frames(kind: str):
    if kind == "clip8":
        return clip64x48_frames(8)
    if kind == "scenecut":
        return scene_cut_frames()
    return intra_frames(kind)


def scene_cut_frames():
    """The 64x48 clip of tests/test_distributed.py:
    test_four_process_scene_cut_gops_with_killed_worker: four random
    scenes cut at SCENE_CUTS, a flat bar moving across each, flat chroma
    that changes at the cuts."""
    w, h = 64, 48
    rng = np.random.RandomState(5)
    scenes = [rng.randint(0, 256, (h, w)).astype(np.uint8)
              for _ in range(4)]
    frames = []
    for i in range(SCENE_FRAMES):
        si = sum(1 for b in SCENE_CUTS if b <= i) - 1
        y = scenes[si].copy()
        y[:, (3 * i) % (w - 8):(3 * i) % (w - 8) + 8] = 128
        frames.append([y, np.full((h // 2, w // 2), 90 + si, np.uint8),
                       np.full((h // 2, w // 2), 160 - si, np.uint8)])
    return frames


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


def _read_stream(name):
    """(info, setup, data packets) of a testdata stream, by the JAX
    package's parsers."""
    from theora_tpu.headers import parse_info_header, parse_setup_header

    path = os.path.join(HERE, name)
    if name.endswith(".ogv"):
        from theora_tpu.ogg import demux_stream

        with open(path, "rb") as f:
            pkts = demux_stream(f.read())
    else:
        from theora_tpu.tpkt import read_tpkt

        pkts = read_tpkt(path)
    return (parse_info_header(pkts[0].data), parse_setup_header(pkts[2].data),
            [p.data for p in pkts[3:]])


def _transcode(name, kf, qi, **kw):
    from theora_tpu.encode.tpu_gop import transcode_device

    info, setup, datas = _read_stream(name)
    return transcode_device(info, setup, datas, keyframe_freq=kf, qi=qi,
                            **kw)


def _transcode_by_host(name, packets, kf, qi):
    """Headers + packets of the host decode of `packets` fed to
    encode_clip: transcode_device's contract."""
    from theora_tpu.decode.decoder import Decoder
    from theora_tpu.encode.tpu_gop import TpuGopEncoder

    info, setup, _ = _read_stream(name)
    dec = Decoder(info, setup)
    frames = []
    for data in packets:
        dec.decode_packet(data)
        frames.append([p.copy() for p in dec.ycbcr_out()])
    return TpuGopEncoder(info, qi=qi).encode_clip(frames, keyframe_freq=kf)


def _mesh_info(quality=40):
    from theora_tpu.info import TheoraInfo

    return TheoraInfo(frame_width=64, frame_height=48, pic_width=64,
                      pic_height=48, quality=quality, fps_numerator=30,
                      fps_denominator=1)


def _mesh(frames, info, nd, frag, **kw):
    from theora_tpu.parallel.gop import encode_clip_mesh, make_mesh

    return encode_clip_mesh(frames, info, make_mesh(nd, frag_axis=frag),
                            **kw)


def _mesh_twopass():
    """Packets of the mesh 2-pass encode, then the pass-1 blob."""
    from theora_tpu.encode.tpu_gop import TpuGopEncoder

    frames = moving_frames(64, 48, 0, MESH_FRAMES, MESH_SEED)
    info = _mesh_info(quality=0)
    _, blob = TpuGopEncoder(info, qi=SMALL_QI).encode_clip_pass1(
        frames, keyframe_freq=SMALL_KF, target_bitrate=MESH_2PASS_RATE)
    pkts = _mesh(frames, info, 8, 2, keyframe_freq=SMALL_KF, qi=SMALL_QI,
                 target_bitrate=MESH_2PASS_RATE, rate_window=2,
                 twopass_data=blob, buf_delay=16)
    return [p.data for p in pkts] + [blob]


def _mesh_sp2():
    """Headers + the packets of mixed_frames() as two 2-frame GOPs in one
    encode_gops batch at speed level 2."""
    from theora_tpu.info import TheoraInfo
    from theora_tpu.parallel.gop import MeshGopEncoder, make_mesh

    frames = mixed_frames()
    info = TheoraInfo(frame_width=MIXED_W, frame_height=MIXED_H,
                      pic_width=MIXED_W, pic_height=MIXED_H,
                      quality=MIXED_QI)
    enc = MeshGopEncoder(make_mesh(2), info, qi=MIXED_QI)
    enc.base.set_splevel(2)
    pkts = enc.encode_gops([frames[:2], frames[2:]])
    return [p.data for p in enc.base.flush_headers()] + pkts[0] + pkts[1]


def _mesh_halftex():
    from theora_tpu.info import TheoraInfo

    info = TheoraInfo(frame_width=MIXED_W, frame_height=MIXED_H,
                      pic_width=MIXED_W, pic_height=MIXED_H,
                      quality=HALFTEX_QI)
    return _mesh(halftexture_frames(), info, 2, 1, keyframe_freq=2,
                 qi=HALFTEX_QI)


def _mesh_hd720_q56():
    from theora_tpu.info import TheoraInfo

    info = TheoraInfo(frame_width=1280, frame_height=720, pic_width=1280,
                      pic_height=720, quality=AQ_QI)
    return _mesh(hd_frames(), info, 2, 1, keyframe_freq=HD_KF, qi=AQ_QI)


def _mesh_hd720_sp2():
    """Headers + the packets of hd_frames() as two 8-frame GOPs in one
    encode_gops batch at q48, speed level 2."""
    from theora_tpu.info import TheoraInfo
    from theora_tpu.parallel.gop import MeshGopEncoder, make_mesh

    frames = hd_frames()
    info = TheoraInfo(frame_width=1280, frame_height=720, pic_width=1280,
                      pic_height=720, quality=HD_QI)
    enc = MeshGopEncoder(make_mesh(2), info, qi=HD_QI)
    enc.base.set_splevel(2)
    pkts = enc.encode_gops([frames[:HD_KF], frames[HD_KF:]])
    return [p.data for p in enc.base.flush_headers()] + pkts[0] + pkts[1]


def _intra(case, target_bitrate=0, check_batch=True):
    """Headers + packets of the JAX host Encoder at keyframe_freq=1 on an
    INTRA_CASES case; with check_batch, JAX's TpuBatchIntraEncoder must
    give the same list."""
    from theora_tpu.encode.encoder import Encoder
    from theora_tpu.encode.tpu_encoder import TpuBatchIntraEncoder
    from theora_tpu.info import TheoraInfo

    kind, w, h, fmt, qi, mode, splevel = INTRA_CASES[case]
    frames = intra_frames(kind)

    def info():
        return TheoraInfo(frame_width=w, frame_height=h, pic_width=w,
                          pic_height=h, quality=qi, pixel_fmt=fmt,
                          target_bitrate=target_bitrate)

    def setup(enc):
        enc.keyframe_freq = 1
        enc.adaptive_quant = mode
        if splevel:
            enc.set_splevel(splevel)
        return enc

    enc = setup(Encoder(info()))
    host = [p.data for p in enc.flush_headers()] + [
        enc.encode_frame(f).data for f in frames]
    if check_batch:
        batch = TpuBatchIntraEncoder(info())
        setup(batch.enc)
        got = [p.data for p in batch.flush_headers() + batch.encode(frames)]
        if got != host:
            raise AssertionError(f"intra {case}: JAX's TpuBatchIntraEncoder "
                                 "differs from its host Encoder")
    return host


def _host(case):
    """Headers + packets of the JAX host Encoder on a HOST_CASES case at
    its keyframe spacing; where the case runs at the Encoder's defaults,
    JAX's GOP-parallel transcode over threads and over processes must
    give the same packets."""
    from theora_tpu.encode.encoder import Encoder
    from theora_tpu.info import TheoraInfo
    from theora_tpu.parallel.transcode import transcode

    kind, w, h, fmt, qi, mode, splevel, kf = HOST_CASES[case]
    frames = host_frames(kind)
    info = TheoraInfo(frame_width=w, frame_height=h, pic_width=w,
                      pic_height=h, quality=qi, pixel_fmt=fmt)
    enc = Encoder(info)
    enc.keyframe_freq = kf
    enc.adaptive_quant = mode
    if splevel:
        enc.set_splevel(splevel)
    host = enc.flush_headers() + [
        enc.encode_frame(f, e_o_s=i == len(frames) - 1)
        for i, f in enumerate(frames)]
    want = [(p.data, p.granulepos, p.e_o_s) for p in host]
    if mode == "auto" and not splevel:
        for kw in ({"max_workers": 4}, {"max_workers": 2,
                                        "use_processes": True}):
            got = transcode(frames, info, keyframe_freq=kf, **kw)
            if [(p.data, p.granulepos, p.e_o_s) for p in got] != want:
                raise AssertionError(f"host {case}: JAX's transcode {kw} "
                                     "differs from its host Encoder")
    return [p.data for p in host]


def _write(name, pkts):
    datas = [p if isinstance(p, bytes) else p.data for p in pkts]
    lines = [hashlib.sha256(d).hexdigest() for d in datas]
    with open(os.path.join(HERE, name), "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"{name}: {len(lines)} lines, {sum(map(len, datas))} bytes")


def _check(name, pkts, seq_name):
    """Write the mesh list `name` unless its hashes equal `seq_name`'s."""
    datas = [p if isinstance(p, bytes) else p.data for p in pkts]
    got = [hashlib.sha256(d).hexdigest() for d in datas]
    with open(os.path.join(HERE, seq_name)) as f:
        want = f.read().split()
    if got == want:
        print(f"{name}: JAX's mesh gives all {len(got)} hashes of "
              f"{seq_name}; not written")
    else:
        print(f"{name}: JAX's mesh differs from {seq_name}")
        _write(name, datas)


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
    "transcode64x48_k6_enc.sha256": lambda: _transcode(
        TC_SOURCE, TC_KF, TC_QI),
    "transcode64x48_dup_enc.sha256": lambda: _transcode_by_host(
        TC_SOURCE, dup_packets(_read_stream(TC_SOURCE)[2]), TC_DUP_KF,
        TC_QI),
    "transcode64x48_cbr_enc.sha256": lambda: _transcode(
        TC_SOURCE, TC_CBR_KF, TC_QI, target_bitrate=TC_CBR_RATE,
        rate_window=1),
    "hd720_transcode_q48_k8_enc.sha256": lambda: _transcode(
        HD_TC_SOURCE, HD_TC_KF, HD_TC_QI),
    "mesh64x48_vbr_enc.sha256": lambda: _mesh(
        moving_frames(64, 48, 0, MESH_FRAMES, MESH_SEED), _mesh_info(), 8, 2,
        keyframe_freq=SMALL_KF, qi=SMALL_QI),
    "mesh64x48_cut_cbr_enc.sha256": lambda: _mesh(
        cut_frames(), _mesh_info(), 4, 1, keyframe_freq=CUT_KF, qi=SMALL_QI,
        target_bitrate=MESH_CBR_RATE, rate_window=3, auto_keyframe=True),
    "mesh64x48_twopass_enc.sha256": _mesh_twopass,
    "mesh96x64_sp2_enc.sha256": _mesh_sp2,
    "mesh96x64_halftex_q48_enc.sha256": _mesh_halftex,
    "intra64x48_enc.sha256": lambda: [
        p for c in INTRA_SMALL for p in _intra(c)],
    "intra96x64_aq_enc.sha256": lambda: [
        p for c in INTRA_AQ for p in _intra(c)],
    "intra64x48_f5_enc.sha256": lambda: _intra(
        F5_CASE, target_bitrate=F5_RATE, check_batch=False),
    "hd720_intra_q48_enc.sha256": lambda: _intra("hd720_q48"),
    "host64x48_enc.sha256": lambda: [
        p for c in HOST_SMALL for p in _host(c)],
    "host96x64_aq_enc.sha256": lambda: [
        p for c in HOST_AQ for p in _host(c)],
    "hd720_host_q48_k8_enc.sha256": lambda: _host("hd720_q48"),
}


# tests/test_torch_encode.py's cases: name -> (pixel format, qi,
# keyframe_freq, frames), adaptive quantization off.
ENC_CASES = {
    **{f"fmt{fmt}": (fmt, SMALL_QI, SMALL_KF,
                     lambda fmt=fmt: moving_frames(64, 48, fmt, SMALL_FRAMES,
                                                   11 + fmt))
       for fmt in SMALL_FORMATS},
    "clip64x48": (0, 32, 4, lambda: clip64x48_frames(8)),
}
# tests/test_torch_adaptive.py's cases: name -> (frames, width, height,
# qi, keyframe_freq, adaptive_quant).
AQ_CASES = {
    "auto_q56_moving": (lambda: moving_frames(64, 48, 0, 5, 51), 64, 48,
                        56, 4, "auto"),
    "true_q40_mixed": (mixed_frames, MIXED_W, MIXED_H, MIXED_QI,
                       MIXED_FRAMES, True),
    "auto_q24_noise": (lambda: noise_frames(5), 64, 48, 24, 4, "auto"),
    "auto_q36_smooth": (lambda: smooth_frames(5), 64, 48, 36, 4, "auto"),
    "auto_q48_halftexture": (halftexture_frames, MIXED_W, MIXED_H,
                             HALFTEX_QI, MIXED_FRAMES, "auto"),
}
RD_STRENGTHS = (3.0, 1.5)


def _enc_cases():
    from theora_tpu.encode.tpu_gop import TpuGopEncoder
    from theora_tpu.info import TheoraInfo

    out = {}
    for name, (fmt, qi, kf, frames) in ENC_CASES.items():
        enc = TpuGopEncoder(TheoraInfo(
            frame_width=64, frame_height=48, pic_width=64, pic_height=48,
            quality=qi, pixel_fmt=fmt), qi=qi)
        enc.adaptive_quant = False
        out[name] = enc.encode_clip(frames(), keyframe_freq=kf,
                                    clip_batch=8)
    return out


def _aq_cases():
    from theora_tpu.encode.tpu_gop import TpuGopEncoder
    from theora_tpu.info import TheoraInfo

    out = {name: _jax_packets(frames(), w, h, 0, qi, kf,
                              adaptive_quant=mode)
           for name, (frames, w, h, qi, kf, mode) in AQ_CASES.items()}
    frames, w, h, qi, kf, _ = AQ_CASES["auto_q48_halftexture"]
    for rd in RD_STRENGTHS:
        enc = TpuGopEncoder(TheoraInfo(frame_width=w, frame_height=h,
                                       pic_width=w, pic_height=h,
                                       quality=qi), qi=qi, rd_strength=rd)
        enc.delta_upload = False
        out[f"rd{rd}"] = enc.encode_clip(frames(), keyframe_freq=kf,
                                         clip_batch=8)
    return out


def _write_records(name, cases):
    """Write {case: packets} as the packet record `name`."""
    lines = [f"{case} {hashlib.sha256(p.data).hexdigest()} {p.granulepos} "
             f"{p.packetno} {int(p.b_o_s)} {int(p.e_o_s)}"
             for case, pkts in cases.items() for p in pkts]
    with open(os.path.join(HERE, name), "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"{name}: {len(cases)} cases, {len(lines)} packets")


def read_records(name: str) -> dict:
    """A packet record as {case: [(SHA-256, granulepos, packetno, b_o_s,
    e_o_s)]}, in order."""
    out = {}
    with open(os.path.join(HERE, name)) as f:
        for line in f:
            case, sha, gp, pno, bos, eos = line.split()
            out.setdefault(case, []).append(
                (sha, int(gp), int(pno), bos == "1", eos == "1"))
    return out


def record_of(pkts) -> list:
    """The record lines' fields of a packet list, as read_records gives
    them."""
    return [(hashlib.sha256(p.data).hexdigest(), p.granulepos, p.packetno,
             bool(p.b_o_s), bool(p.e_o_s)) for p in pkts]


PKT_RECORDS = {"enc64x48_cases.pkts": _enc_cases,
               "aq_cases.pkts": _aq_cases}


def cropped60x44(frames):
    """The frames cut to a 60x44 4:2:0 picture."""
    return [[p[:44, :60] if i == 0 else p[:22, :30]
             for i, p in enumerate(fr)] for fr in frames]


# The CLI tests' cases: name -> (frames, the encoder CLI's flags after
# --device).
CLI_CASES = {
    "clip60x44_q36_k8_aq_off": (
        lambda: cropped60x44(clip64x48_frames(8) + clip64x48_frames(1)),
        ["--adaptive-quant", "off", "-q", "36", "-k", "8"]),
    "noise60x44_defaults": (lambda: cropped60x44(noise_frames(5)), []),
}


def _cli_hashes():
    """{case: SHA-256 of the JAX CLI's .ogv} for CLI_CASES."""
    import tempfile

    from theora_tpu.tools import enc as jenc
    from theora_tpu_torch.tools.y4m import write_y4m

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, (frames, flags) in CLI_CASES.items():
            y4m, ogv = (os.path.join(tmp, f"{name}.{e}")
                        for e in ("y4m", "ogv"))
            write_y4m(y4m, frames())
            jenc.main(["--device", *flags, y4m, ogv])
            with open(ogv, "rb") as f:
                out[name] = hashlib.sha256(f.read()).hexdigest()
    return out


def _write_cli(name, hashes):
    with open(os.path.join(HERE, name), "w") as f:
        f.write("".join(f"{k} {v}\n" for k, v in hashes.items()))
    print(f"{name}: {len(hashes)} cases")


def read_cli(name: str = "cli_cases.sha256") -> dict:
    """{case: SHA-256} of the JAX CLI's outputs."""
    with open(os.path.join(HERE, name)) as f:
        return dict(line.split() for line in f if line.strip())


# Mesh list -> (its packets, the sequential list they are checked against).
CHECKS = {
    "hd720_mesh_q56_k8_enc.sha256": (_mesh_hd720_q56,
                                     "hd720_q56_k8_aq_enc.sha256"),
    "hd720_mesh_q48_k8_sp2_enc.sha256": (_mesh_hd720_sp2,
                                         "hd720_q48_k8_sp2_enc.sha256"),
}


def main(names=None) -> None:
    sys.path.insert(0, os.path.dirname(HERE))
    import time

    # The mesh lists run on the CPU's 8-device virtual mesh
    # (tests/conftest.py).
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    for name in names or [*LISTS, *PKT_RECORDS, "cli_cases.sha256",
                          *CHECKS]:
        t0 = time.perf_counter()
        if name == "cli_cases.sha256":
            _write_cli(name, _cli_hashes())
        elif name in PKT_RECORDS:
            _write_records(name, PKT_RECORDS[name]())
        elif name in CHECKS:
            fn, seq_name = CHECKS[name]
            _check(name, fn(), seq_name)
        else:
            _write(name, LISTS[name]())
        print(f"{name}: {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main(sys.argv[1:])
