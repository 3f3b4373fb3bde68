"""Per-frame and global PSNR (and luma SSIM) between two .y4m files (the
dump_psnr analogue, examples/dump_psnr.c, extended with SSIM).

Port of theora_tpu/tools/psnr.py: the same lines, with the planes'
squared errors and the SSIM (theora_tpu_torch/metrics.py) computed in
float64 on --device (the card unless ``--device cpu``).

Usage: python -m theora_tpu_torch.tools.psnr [--quiet] [--no-ssim]
           [--device D] a.y4m b.y4m
"""
from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("file1")
    ap.add_argument("file2")
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--no-ssim", action="store_true",
                    help="skip the SSIM computation (PSNR only)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the metrics; 'cpu' for the CPU")
    args = ap.parse_args(argv)

    import torch

    from theora_tpu_torch import resolve_device
    from theora_tpu_torch.metrics import ssim
    from theora_tpu_torch.tools.y4m import read_y4m

    dev = resolve_device(args.device)
    *_, fa = read_y4m(args.file1)
    *_, fb = read_y4m(args.file2)
    n = min(len(fa), len(fb))
    gsse = np.zeros(3)
    gn = np.zeros(3)
    ssims = []
    for i in range(n):
        psnrs = []
        planes = []
        for pli in range(3):
            a = torch.from_numpy(np.array(fa[i][pli])).to(dev, torch.float64)
            b = torch.from_numpy(np.array(fb[i][pli])).to(dev, torch.float64)
            planes.append(a)
            sse = float(((a - b) ** 2).sum())
            gsse[pli] += sse
            gn[pli] += a.numel()
            mse = sse / a.numel()
            psnrs.append(10 * np.log10(255.0**2 / mse) if mse
                         else float("inf"))
        line = (
            f"frame {i}: Y {psnrs[0]:.4f}  Cb {psnrs[1]:.4f}  "
            f"Cr {psnrs[2]:.4f}"
        )
        if not args.no_ssim:
            s = ssim(planes[0], torch.from_numpy(np.array(fb[i][0])).to(
                dev, torch.float64))
            ssims.append(s)
            line += f"  SSIM {s:.5f}"
        if not args.quiet:
            print(line)
    names = "Y", "Cb", "Cr"
    out = {}
    for pli in range(3):
        mse = gsse[pli] / gn[pli] if gn[pli] else 0.0
        p = 10 * np.log10(255.0**2 / mse) if mse else float("inf")
        out[names[pli]] = p
        print(f"Total {names[pli]}: {p:.4f} dB", file=sys.stderr)
    if ssims:
        out["SSIM"] = float(np.mean(ssims))
        print(f"Mean luma SSIM: {out['SSIM']:.5f}", file=sys.stderr)
    return out


if __name__ == "__main__":
    main()
