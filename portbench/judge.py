"""The reference's verdict on one session's sampled output.

Usage: python judge.py SESSION_PICKLE CONFIG_JSON SEED [--control]

Reads what a worker wrote (worker.py): the stream's headers and the
sampled packets of its first job, or, for the decode entry, the input
packets and the port's decoded frames. Decodes them with the plain
reference decoder (reference/decoder.py) and prints one JSON object with
the numbers the harness compares against its limits:

- encode and transcode: `bad_packets`, the sampled packets the reference
  rejects or that are missing; `mse_max`, the largest mean squared error
  of a sampled frame's three planes against the source frame the session
  synthesised (synth.py); and `kbit_per_frame_max`, the sampled packets'
  mean size in kbit (the largest over the sessions, as every *_max);
- decode: `bad_packets`, and `mismatched_bytes`, the bytes of the sampled
  frames where the port's output and the reference's differ (a missing
  frame counts all its bytes).

With --control the reference decodes in the lower precision its control
takes (reference/decoder.py): for encode and transcode the coefficients
lose their lowest bit, as if the program had coded them at half the
precision, and for decode the float iDCT takes the integer one's place,
and its frames take the port's.

Imports nothing of the port.
"""
from __future__ import annotations

import json
import os
import pickle
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from reference.decoder import BadPacket, RefDecoder  # noqa: E402
from synth import Clip  # noqa: E402


def _frame_bytes(fr) -> np.ndarray:
    return np.concatenate([np.asarray(p, np.uint8).ravel() for p in fr])


def judge(sample: dict, cfg: dict, seed: int, control: bool = False) -> dict:
    entry = sample["entry"]
    idx = sample["sample"]
    if entry == "decode":
        exact = RefDecoder(sample["headers"])
        low = RefDecoder(sample["headers"], "float_idct") if control \
            else None
        got = sample["output"] or []
        bad = mism = 0
        first = idx[0]
        for k, pkt in enumerate(sample["input"]):
            try:
                ref = exact.decode(pkt)
            except BadPacket:
                bad += 1
                continue
            if low is not None:
                mine = low.decode(pkt)
            else:
                pos = idx.index(first + k)
                mine = got[pos] if pos < len(got) else None
            want = _frame_bytes(ref)
            if mine is None:
                mism += want.size
                continue
            have = _frame_bytes(mine)
            mism += (int((have != want).sum()) if have.size == want.size
                     else want.size)
        return {"bad_packets": bad, "mismatched_bytes": mism}
    clip = Clip(cfg["width"], cfg["height"], seed)
    out = sample["output"] or []
    dec = RefDecoder(out[:3], "coef_lsb" if control else None)
    packets = out[3:]
    bad = 0
    mse = 0.0
    for k, i in enumerate(idx):
        if k >= len(packets):
            bad += len(idx) - k
            break
        try:
            fr = dec.decode(packets[k])
        except BadPacket:
            bad += len(idx) - k
            break
        src = _frame_bytes(clip.frame(i)).astype(np.int64)
        err = _frame_bytes(fr).astype(np.int64) - src
        mse = max(mse, float(np.mean(err * err)))
    kbit = 8e-3 * sum(len(p) for p in packets[:len(idx)]) / max(len(idx), 1)
    return {"bad_packets": bad, "mse_max": mse, "kbit_per_frame_max": kbit}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    control = "--control" in argv
    path, cfg_json, seed = [a for a in argv if a != "--control"]
    with open(path, "rb") as f:
        sample = pickle.load(f)
    with open(cfg_json) as f:
        cfg = json.load(f)
    print(json.dumps(judge(sample, cfg, int(seed), control)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
