"""Generate the records that hold the PyTorch port's tools
(theora_tpu_torch/tools/qualitysweep.py, collect.py) to the JAX
package's, with the JAX package on the CPU.

- sweep96x80_dev.json: the rows of ``python -m
  theora_tpu.tools.qualitysweep --size 96x80 --frames 4 --qis 24,48
  --content smooth,textured --skip ref,host --adaptive --json ...``: the
  device columns (adaptive quantization "auto", and True) at a test's
  size (tests/test_torch_tools.py);
- sweep720_dev.sha256 and sweep720_host.sha256: the packets (SHA-256 per
  packet, headers first) of the sweep's device column (adaptive "auto")
  and host column at --size 1280x720 --frames 16 --qis 24,48 --content
  smooth,textured, in the sweep's order (content, then qi), one block of
  19 lines per stream; the device streams come from one TpuGopEncoder
  built at the first qi and reused through set_qi, as the JAX tool runs
  it (chip_smoke.py phase 13a only);
- collect720_moderd.sha256: the host Encoder with mode_rd and collect on
  the first 8 frames of make_hd720.source_frames() (1280x720), a
  keyframe every 8, at qi 24 and then 48, as ``theora_tpu.tools.collect
  --mode-rd`` gathers them: per qi the packets' lines ("p" and the
  SHA-256) and then one line per collected frame ("r" and the SHA-256 of
  its [n, 7] int64 little-endian rows) (chip_smoke.py phase 13c only).
  On this source the 4MV block refinement returns -32 half-pel
  components, which JAX's mode_rd cannot price (fault F13: KeyError); the
  port leaves 4MV out of such an MB's candidates, and the JAX encoder
  does the same through an infinite price in its _mv_len cache
  (f13_mv_len).

This is a one-off generator, run on the CPU from the repository root:

    JAX_PLATFORMS=cpu python testdata/make_tools.py [NAME ...]

It is not part of the PyTorch port and pytest does not collect it.
"""
from __future__ import annotations

import hashlib
import importlib.util
import json
import os
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

SWEEP_ARGS = ["--size", "1280x720", "--frames", "16", "--qis", "24,48",
              "--content", "smooth,textured"]
SMALL_SWEEP_ARGS = ["--size", "96x80", "--frames", "4", "--qis", "24,48",
                    "--content", "smooth,textured", "--skip", "ref,host",
                    "--adaptive"]
COLLECT_QIS = (24, 48)
COLLECT_FRAMES = 8
COLLECT_KF = 8


def hd_source():
    spec = importlib.util.spec_from_file_location(
        "make_hd720", os.path.join(HERE, "make_hd720.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.source_frames()


def rows_hash(rows: np.ndarray) -> str:
    return hashlib.sha256(
        np.ascontiguousarray(rows, dtype="<i8").tobytes()).hexdigest()


def read_collect(name: str = "collect720_moderd.sha256") -> dict:
    """{qi: (packet hashes, per-frame rows hashes)} of the collect list."""
    out = {}
    with open(os.path.join(HERE, name)) as f:
        lines = [ln.split() for ln in f if ln.strip()]
    qi = None
    for ln in lines:
        if ln[0] == "qi":
            qi = int(ln[1])
            out[qi] = ([], [])
        else:
            out[qi][0 if ln[0] == "p" else 1].append(ln[1])
    return out


def _small_sweep(path):
    from theora_tpu.tools import qualitysweep as qs

    argv = sys.argv
    sys.argv = ["qualitysweep", *SMALL_SWEEP_ARGS, "--json", path]
    try:
        qs.main()
    finally:
        sys.argv = argv


def _sweep720():
    """(device packets, host packets) per stream in the sweep's order,
    by the JAX tool's own functions and its encoder cache."""
    from theora_tpu.encode.encoder import Encoder
    from theora_tpu.encode.tpu_gop import TpuGopEncoder
    from theora_tpu.tools import qualitysweep as qs

    qs.W, qs.H = 1280, 720
    dev, host = [], []
    enc = None
    for kind in ("smooth", "textured"):
        frames = qs.gen_content(kind, 16)
        for qi in (24, 48):
            he = Encoder(qs.mk_info(qi))
            he.keyframe_freq = qs.KF
            host.append(list(he.flush_headers())
                        + [he.encode_frame(fr) for fr in frames])
            if enc is None:
                enc = TpuGopEncoder(qs.mk_info(qi), qi=qi)
                enc.adaptive_quant = "auto"
            enc.set_qi(qi)
            dev.append(enc.encode_clip(frames, keyframe_freq=qs.KF))
            print(f"  sweep {kind} q{qi}: host "
                  f"{sum(len(p.data) for p in host[-1][3:])} B, device "
                  f"{sum(len(p.data) for p in dev[-1][3:])} B")
    return dev, host


def f13_mv_len() -> dict:
    """JAX mode_rd's MV bit lengths with an infinite price for the
    uncodable -32: a walk at a positive discount prices 4MV at inf, and
    the 0.0 walk's inf * 0 is nan, which min never picks after the NOMV
    candidate it compares first; so 4MV is out of that MB's candidates,
    as in the port."""
    from theora_tpu.huffman import MV_VLC_BOOK

    lens = {}
    for t, _, nb in MV_VLC_BOOK.codes:
        lens.setdefault(t - 32, nb)
    lens[-32] = float("inf")
    return lens


def _collect720():
    from theora_tpu.encode.encoder import Encoder
    from theora_tpu.info import TheoraInfo

    frames = hd_source()[:COLLECT_FRAMES]
    out = {}
    for qi in COLLECT_QIS:
        info = TheoraInfo(frame_width=1280, frame_height=720,
                          pic_width=1280, pic_height=720, quality=qi)
        enc = Encoder(info)
        enc.keyframe_freq = COLLECT_KF
        enc.mode_rd = True
        enc._mv_len = f13_mv_len()
        enc.collect = []
        pk = enc.flush_headers()
        for fr in frames:
            pk.append(enc.encode_frame(fr))
        out[qi] = (pk, enc.collect)
        print(f"  collect q{qi}: {sum(len(r) for r in enc.collect)} rows")
    return out


def main(names=None) -> None:
    sys.path.insert(0, os.path.dirname(HERE))
    import jax

    jax.config.update("jax_platforms", "cpu")
    names = names or ["sweep96x80_dev.json", "sweep720", "collect720"]
    if "sweep96x80_dev.json" in names:
        with tempfile.TemporaryDirectory() as td:
            p = os.path.join(td, "rows.json")
            _small_sweep(p)
            with open(p) as f:
                rows = json.load(f)
        with open(os.path.join(HERE, "sweep96x80_dev.json"), "w") as f:
            json.dump(rows, f, indent=1)
            f.write("\n")
    if "sweep720" in names:
        dev, host = _sweep720()
        for name, streams in (("sweep720_dev.sha256", dev),
                              ("sweep720_host.sha256", host)):
            with open(os.path.join(HERE, name), "w") as f:
                for pk in streams:
                    f.write("".join(hashlib.sha256(p.data).hexdigest()
                                    + "\n" for p in pk))
    if "collect720" in names:
        out = _collect720()
        with open(os.path.join(HERE, "collect720_moderd.sha256"), "w") as f:
            for qi, (pk, rows) in out.items():
                f.write(f"qi {qi}\n")
                f.write("".join(f"p {hashlib.sha256(p.data).hexdigest()}\n"
                                for p in pk))
                f.write("".join(f"r {rows_hash(r)}\n" for r in rows))


if __name__ == "__main__":
    main(sys.argv[1:])
