"""Quality metrics: PSNR and SSIM, in float64 on the device of the inputs.

Port of theora_tpu/metrics.py. PSNR over a plane, mean SSIM over a plane
(Wang et al. 2004: an 11x11 Gaussian window of sigma 1.5, K1 = 0.01,
K2 = 0.03, 'valid' support), the clip's mean luma SSIM and its pooled
luma PSNR (the dump_psnr.c convention). The inputs are numpy arrays or
tensors; numpy arrays are taken to the CPU, tensors stay where they are.
The separable Gaussian is 11 shifted multiply-adds per axis, summed in
the JAX package's order, so the float64 results agree with it.
"""
from __future__ import annotations

import math

import numpy as np
import torch

_K1, _K2 = 0.01, 0.03
_WIN = 11
_SIGMA = 1.5


def _gaussian_kernel(n: int = _WIN, sigma: float = _SIGMA) -> np.ndarray:
    r = np.arange(n) - (n - 1) / 2.0
    w = np.exp(-(r * r) / (2.0 * sigma * sigma))
    return w / w.sum()


_G = [float(g) for g in _gaussian_kernel()]


def _f64(x, device=None) -> torch.Tensor:
    """x as a float64 tensor on device (a tensor's own device, or the CPU
    for numpy input, by default)."""
    if not torch.is_tensor(x):
        x = torch.from_numpy(np.asarray(x, dtype=np.float64))
    return x.to(device=device if device is not None else x.device,
                dtype=torch.float64)


def _filt_valid(x: torch.Tensor) -> torch.Tensor:
    """Separable Gaussian filter, 'valid' support (H-10, W-10)."""
    k = len(_G)
    h = x.shape[0] - k + 1
    w = x.shape[1] - k + 1
    if h < 0 or w < 0:
        # numpy's error for the JAX package's np.zeros of this shape.
        raise ValueError("negative dimensions are not allowed")
    t = torch.zeros((h, x.shape[1]), dtype=torch.float64, device=x.device)
    for i, g in enumerate(_G):
        t += g * x[i:i + h]
    out = torch.zeros((h, w), dtype=torch.float64, device=x.device)
    for i, g in enumerate(_G):
        out += g * t[:, i:i + w]
    return out


def psnr(a, b, peak: float = 255.0) -> float:
    a = _f64(a)
    d = a - _f64(b, a.device)
    mse = float((d * d).mean())
    if mse == 0:
        return float("inf")
    return 10.0 * math.log10(peak * peak / mse)


def ssim(a, b, peak: float = 255.0) -> float:
    """Mean SSIM over one plane."""
    a = _f64(a)
    b = _f64(b, a.device)
    c1 = (_K1 * peak) ** 2
    c2 = (_K2 * peak) ** 2
    mu_a = _filt_valid(a)
    mu_b = _filt_valid(b)
    mu_aa = mu_a * mu_a
    mu_bb = mu_b * mu_b
    mu_ab = mu_a * mu_b
    var_a = _filt_valid(a * a) - mu_aa
    var_b = _filt_valid(b * b) - mu_bb
    cov = _filt_valid(a * b) - mu_ab
    num = (2.0 * mu_ab + c1) * (2.0 * cov + c2)
    den = (mu_aa + mu_bb + c1) * (var_a + var_b + c2)
    return float((num / den).mean())


def clip_luma_ssim(frames_a, frames_b) -> float:
    """Mean per-frame luma SSIM over a clip (each item: [y, u, v])."""
    vals = [ssim(fa[0], fb[0]) for fa, fb in zip(frames_a, frames_b)]
    return float(np.mean(vals)) if vals else float("nan")


def clip_luma_psnr(frames_a, frames_b) -> float:
    """Global luma PSNR over a clip (SSE pooled across frames)."""
    se = 0.0
    n = 0
    for fa, fb in zip(frames_a, frames_b):
        a = _f64(fa[0])
        d = a - _f64(fb[0], a.device)
        se += float((d * d).sum())
        n += d.numel()
    if se == 0:
        return float("inf")
    return 10.0 * np.log10(255.0 * 255.0 * n / se)
