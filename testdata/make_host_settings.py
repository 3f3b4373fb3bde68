"""Packet lists of the JAX host Encoder under the settings off its
defaults, for chip_smoke.py phase 12i.

Each run encodes the first HD_FRAMES frames of testdata/make_hd720.py's
1280x720 source (make_hd720_enc.hd_frames) with the host Encoder at a
keyframe every HD_KF and adaptive quantization "auto", with one of the
HD_RUNS settings:

- coupled_skip at q48, and at q40, where the closed loop filters;
- luma_ext_skip at q40;
- aq_estimate_margin=8.0 at q56, where the qi triple engages;
- use_trellis=False at q56 (the triple's activity terciles);
- auto_keyframe=False with skip_lambda_scale=1.0 at q48.

host_settings720.pkts holds one line per packet, "<run> <SHA-256>
<granulepos> <packetno> <b_o_s> <e_o_s>" (flags 0 or 1), each run's three
headers first (make_hd720_enc.read_records reads it). Before it writes
the file, the generator decodes every run's stream with the JAX host
Decoder to its end.

This is a one-off generator, run on the CPU from the repository root:

    JAX_PLATFORMS=cpu python testdata/make_host_settings.py

It imports the JAX package, is not part of the PyTorch port, and pytest
does not collect it. At import it needs numpy only: chip_smoke.py and
the port's tests read HD_RUNS, encode() and the list through it.
"""
from __future__ import annotations

import importlib.util
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))

NAME = "host_settings720.pkts"
HD_FRAMES = 8
HD_KF = 8
# run -> (qi, the Encoder attributes set after construction).
HD_RUNS = {
    "coupled_q48": (48, {"coupled_skip": True}),
    "coupled_q40": (40, {"coupled_skip": True}),
    "luma_ext_q40": (40, {"luma_ext_skip": True}),
    "estimate_q56": (56, {"aq_estimate_margin": 8.0}),
    "notrellis_q56": (56, {"use_trellis": False}),
    "noautokf_q48": (48, {"auto_keyframe": False,
                          "skip_lambda_scale": 1.0}),
}


def _mk():
    spec = importlib.util.spec_from_file_location(
        "make_hd720_enc", os.path.join(HERE, "make_hd720_enc.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


mk = _mk()


def hd_frames():
    return mk.hd_frames()[:HD_FRAMES]


def encode(Encoder, TheoraInfo, frames, qi, attrs, keyframe_freq=HD_KF,
           pixel_fmt=0, adaptive_quant="auto", splevel=0, **enc_kwargs):
    """Headers + packets of one host Encoder (either package's: Encoder
    and TheoraInfo are passed in) over frames, with attrs set after
    construction. Returns (packets, the encoder)."""
    h, w = frames[0][0].shape
    enc = Encoder(TheoraInfo(frame_width=w, frame_height=h, pic_width=w,
                             pic_height=h, quality=qi, pixel_fmt=pixel_fmt),
                  **enc_kwargs)
    enc.keyframe_freq = keyframe_freq
    enc.adaptive_quant = adaptive_quant
    if splevel:
        enc.set_splevel(splevel)
    for k, v in attrs.items():
        setattr(enc, k, v)
    pkts = enc.flush_headers() + [
        enc.encode_frame(f, e_o_s=i == len(frames) - 1)
        for i, f in enumerate(frames)]
    return pkts, enc


def multi_qi_frames(pkts) -> list:
    """The data packets (frame indices) whose frame header lists more
    than one qi: the qi triple engaged."""
    return [i for i, p in enumerate(pkts[3:])
            if len(p.data) > 1 and p.data[1] >> 7]


def main() -> None:
    import hashlib
    import time

    sys.path.insert(0, os.path.dirname(HERE))
    from theora_tpu.decode.decoder import Decoder
    from theora_tpu.encode.encoder import Encoder
    from theora_tpu.headers import parse_info_header, parse_setup_header
    from theora_tpu.info import TheoraInfo

    frames = hd_frames()
    lines = []
    for run, (qi, attrs) in HD_RUNS.items():
        t0 = time.perf_counter()
        pkts, _ = encode(Encoder, TheoraInfo, frames, qi, attrs)
        dec = Decoder(parse_info_header(pkts[0].data),
                      parse_setup_header(pkts[2].data))
        for p in pkts[3:]:
            dec.decode_packet(p.data)
        lines += [f"{run} {hashlib.sha256(p.data).hexdigest()} "
                  f"{p.granulepos} {p.packetno} {int(p.b_o_s)} "
                  f"{int(p.e_o_s)}" for p in pkts]
        print(f"{run}: {len(pkts)} packets, "
              f"{sum(len(p.data) for p in pkts[3:])} bytes, "
              f"{len(multi_qi_frames(pkts))} frames with more than one qi, "
              f"decoded to the end; {time.perf_counter() - t0:.1f} s",
              flush=True)
    with open(os.path.join(HERE, NAME), "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"{NAME}: {len(HD_RUNS)} runs, {len(lines)} packets")


if __name__ == "__main__":
    main()
