"""R-D metrics collection + mode-decision table fitting.

Port of theora_tpu/tools/collect.py over the port's host Encoder (its
closed loop decoded on --device, the card unless ``--device cpu``); fit()
and write_tables() are the JAX tool's numpy code.

The collect.c / tools/process_modedec_stats.c analogue: encodes training
clips across the quantizer range with per-fragment metric collection
(SATD of the mode prediction residual, actual coded bits, actual
reconstruction SSD), then fits the mode-decision rate/RMSE tables
(modedec.h analogue) as 8 log-quantizer anchor rows x 24 SATD bins per
(plane-class, frame-type), written to theora_tpu_torch/modedec_tables.py.

Usage:
  python -m theora_tpu_torch.tools.collect \
      [--out theora_tpu_torch/modedec_tables.py] [--mode-rd] [--device D] \
      clip1.i420:W:H [clip2.i420:W:H ...]
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

NBINS = 24
NLOGQ = 8
# Log-spaced SATD bin edges: fine at low SATD where mode decisions are
# actually made on coherent content (satd 0 vs ~200 is the NOMV-vs-MV
# question), coarse at the top.  Redesign of the reference's uniform
# 512-wide bins (modedec.h), which collapse that whole region into one
# bin -- see theora_tpu_torch/encode/modedec.py:satd_bin.
SATD_EDGES = [
    0, 32, 64, 96, 128, 192, 256, 384, 512, 768, 1024, 1408, 1792,
    2304, 2816, 3584, 4352, 5376, 6656, 8192, 10240, 12800, 16384,
    20480,
]


def read_clip(path, W, H, max_frames=32):
    """The first max_frames 4:2:0 frames of a raw .i420 file."""
    raw = np.fromfile(path, dtype=np.uint8)
    fsz = W * H * 3 // 2
    n = min(len(raw) // fsz, max_frames)
    frames = []
    for i in range(n):
        f = raw[i * fsz : (i + 1) * fsz]
        frames.append(
            [
                f[: W * H].reshape(H, W),
                f[W * H : W * H + fsz // 6].reshape(H // 2, W // 2),
                f[W * H + fsz // 6 : fsz].reshape(H // 2, W // 2),
            ]
        )
    return frames


def gather(clips, qis, kf=8, max_frames=32, mode_rd=False, device="cuda",
           record=None):
    """mode_rd=True collects under the fitted-R/D mode policy itself
    (one step of policy iteration: the training distribution is
    conditioned on the deciding policy, so fitting from heuristic-policy
    encodes and deploying under mode_rd is a distribution shift).
    record: a list that gets, per encode, its packets (headers first) and
    its rows frame by frame (the encoder's collect list)."""
    from theora_tpu_torch.encode.encoder import Encoder
    from theora_tpu_torch.info import TheoraInfo

    rows = []
    for path, W, H in clips:
        frames = read_clip(path, W, H, max_frames)
        for qi in qis:
            info = TheoraInfo(
                frame_width=W, frame_height=H, pic_width=W, pic_height=H,
                quality=qi,
            )
            enc = Encoder(info, device=device)
            enc.keyframe_freq = kf
            enc.mode_rd = mode_rd
            enc.collect = []
            pk = enc.flush_headers()
            for fr in frames:
                pk.append(enc.encode_frame(fr))
            if record is not None:
                record.append((pk, enc.collect))
            rows.extend(enc.collect)
            print(f"  {path} qi={qi}: {sum(len(r) for r in enc.collect)} rows",
                  file=sys.stderr)
    return np.concatenate(rows)


def fit(rows, dequant):
    """rows: [N, 7] (qi, pli, qti, satd, bits, ssd, ctx) -- ctx is the
    causal neighborhood context (mean chosen-mode SATD of the left/up
    neighbor fragments), collected for the block-context experiment
    that closed the mode_rd question (ROUND_NOTES round 4: no held-out
    predictive gain) and ignored by this fit. Returns
    (logq_anchors [2][2][NLOGQ], rate [2][2][NLOGQ][NBINS],
    rmse [2][2][NLOGQ][NBINS]) with pli collapsed to luma/chroma classes.
    """
    qi = rows[:, 0].astype(int)
    plc = (rows[:, 1] > 0).astype(int)   # 0 luma, 1 chroma
    qti = rows[:, 2].astype(int)
    # Chroma SATD values are spread over fewer bins; scale by 4 like the
    # reference (analyze.c:1131) so the bins resolve them.
    satd = rows[:, 3] * np.where(plc > 0, 4, 1)
    bits = rows[:, 4].astype(np.float64)
    # SSD in pixel domain -> match the x16 coefficient-domain convention.
    ssd = rows[:, 5].astype(np.float64) * 16.0
    logq_row = np.log(
        np.array([[dequant[q, int(p) and 1, t][1] for q, p, t
                   in zip(qi, plc, qti)]])
    ).reshape(-1)
    bins = np.minimum(
        np.searchsorted(np.asarray(SATD_EDGES), satd, side="right") - 1,
        NBINS - 1,
    )

    anchors = np.zeros((2, 2, NLOGQ))
    rate_t = np.zeros((2, 2, NLOGQ, NBINS))
    rmse_t = np.zeros((2, 2, NLOGQ, NBINS))
    for pc in range(2):
        for t in range(2):
            m = (plc == pc) & (qti == t)
            if not m.any():
                continue
            lq = logq_row[m]
            lo, hi = lq.min(), lq.max()
            anc = np.linspace(hi, lo, NLOGQ)  # descending like the ref
            anchors[pc, t] = anc
            bw = max((hi - lo) / (NLOGQ - 1), 1e-3)
            for ai, a in enumerate(anc):
                w_lq = np.maximum(0.0, 1.0 - np.abs(lq - a) / (1.5 * bw))
                for b in range(NBINS):
                    sel = (bins[m] == b) & (w_lq > 0)
                    wsum = w_lq[sel].sum()
                    if wsum > 0:
                        rate_t[pc, t, ai, b] = (
                            (bits[m][sel] * w_lq[sel]).sum() / wsum
                        )
                        rmse_t[pc, t, ai, b] = np.sqrt(
                            (ssd[m][sel] * w_lq[sel]).sum() / wsum
                        )
                    else:
                        rate_t[pc, t, ai, b] = np.nan
                        rmse_t[pc, t, ai, b] = np.nan
            # Fill empty bins: interpolate interior gaps along the bin
            # axis, then LINEAR-EXTRAPOLATE the unpopulated tail from
            # the last two populated bins (in SATD-edge space).  A flat
            # fill would freeze rate/rmse at each population's data
            # ceiling, and since intra/inter populations truncate at
            # different SATDs, the frozen ceilings cross and the mode
            # decision floods INTRA at high q (measured on held-out
            # content: +166% bytes at q56 before this extrapolation).
            ecent = np.asarray(SATD_EDGES, np.float64)
            for tab in (rate_t, rmse_t):
                for ai in range(NLOGQ):
                    v = tab[pc, t, ai]
                    good = np.flatnonzero(~np.isnan(v))
                    if len(good) == 0:
                        v[:] = 0.0
                        continue
                    v[:] = np.interp(np.arange(NBINS), good,
                                     v[good])
                    k = good[-1]
                    if k < NBINS - 1 and len(good) >= 2:
                        j = good[-2]
                        slope = (v[k] - v[j]) / max(
                            ecent[k] - ecent[j], 1.0
                        )
                        v[k + 1:] = v[k] + slope * (
                            ecent[k + 1:] - ecent[k]
                        )
            # Enforce monotonic non-decreasing rate/rmse over SATD.
            for tab in (rate_t, rmse_t):
                np.maximum.accumulate(tab[pc, t], axis=1, out=tab[pc, t])
    return anchors, rate_t, rmse_t


def write_tables(path, anchors, rate_t, rmse_t):
    with open(path, "w") as f:
        f.write('"""AUTO-GENERATED by theora_tpu_torch.tools.collect -- '
                "mode-decision R-D tables.\n\n"
                "Fitted rate (bits) and RMSE (x4-DCT-domain) per 8x8 block "
                "as functions of\nprediction-residual SATD, at "
                f"{NLOGQ} log-quantizer anchors x {NBINS} log-spaced "
                "SATD bins\n(chroma SATD scaled x4), per "
                "(plane-class, frame-type).\nThe modedec.h analogue, "
                'regenerated from our own encoder statistics."""\n')
        f.write(f"NBINS = {NBINS}\nNLOGQ = {NLOGQ}\n"
                f"SATD_EDGES = {SATD_EDGES}\n\n")
        def dump(name, arr, fmt):
            f.write(f"{name} = ")
            f.write(np.array2string(
                np.asarray(arr), separator=", ",
                formatter={"float_kind": fmt}, threshold=1 << 30,
                max_line_width=78).replace("[", "[\n " if False else "[")
            )
            f.write("\n\n")
        dump("LOGQ_ANCHORS", anchors, lambda x: f"{x:.4f}")
        dump("RATE", rate_t, lambda x: f"{x:.1f}")
        dump("RMSE", rmse_t, lambda x: f"{x:.1f}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("clips", nargs="+", help="path.i420:W:H")
    ap.add_argument("--out", default="theora_tpu_torch/modedec_tables.py")
    ap.add_argument("--qis", default="4,10,16,22,28,34,40,46,52,58,63")
    ap.add_argument("--mode-rd", action="store_true",
                    help="collect under the fitted-R/D mode policy "
                         "(policy iteration; needs existing tables)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the encoders' closed loop; "
                         "'cpu' for the CPU")
    args = ap.parse_args(argv)
    clips = []
    for c in args.clips:
        p, w, h = c.rsplit(":", 2)
        clips.append((p, int(w), int(h)))
    qis = [int(q) for q in args.qis.split(",")]
    rows = gather(clips, qis, mode_rd=args.mode_rd, device=args.device)
    print(f"total {len(rows)} fragment samples", file=sys.stderr)
    from theora_tpu_torch import tables
    from theora_tpu_torch.quant import dequant_tables_init

    dequant = dequant_tables_init(tables.DEF_QUANT_INFO)
    anchors, rate_t, rmse_t = fit(rows, dequant)
    write_tables(args.out, anchors, rate_t, rmse_t)
    print(f"wrote {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
