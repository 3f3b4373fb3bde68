"""The hand kernels the yardstick knows: for each, the port's wrapper that
launches it, the device kernel names it launches per call (found in a
trace by name), and the bound of one call's arguments (bounds.py).

After tools/profile_encode.py:_kernel_stages at commit 6cd77e7, without
the postprocessor KP, which no cell runs. A wrapper that a later change
renames or removes is simply not found: its bound is then missing and its
launches leave the roofline's sum.
"""
from __future__ import annotations

import importlib
import inspect
import re

from yardstick import bounds

# key: (wrapper module, wrapper name, kernel names, bound of the bound
# arguments as a tuple)
KERNELS = {
    "KM": ("theora_tpu_torch.ops.me_cuda", "plan_with_gold",
           ("me_search_kernel", "me_cands_kernel", "me_cand_sads_kernel"),
           lambda a: bounds.km_bound(a[0])),
    "K2": ("theora_tpu_torch.ops.fdct_cuda", "mc_fdct_quantize",
           ("fdct_quant_kernel",),
           lambda a: bounds.fused_bound("mc_fdct_quantize", a)),
    "KT": ("theora_tpu_torch.ops.trellis_cuda", "trellis_quantize",
           ("trellis_kernel",), bounds.kt_bound),
    "KR": ("theora_tpu_torch.ops.qrd_cuda", "mc_fdct_quantize_rd",
           ("fdct_qrd_kernel",),
           lambda a: bounds.fused_bound("mc_fdct_quantize_rd", a)),
    "K1": ("theora_tpu_torch.ops.idct_cuda", "mc_idct_recon_skip",
           ("mc_idct_recon_skip_kernel",),
           lambda a: bounds.fused_bound("mc_idct_recon_skip", a)),
    "K1d": ("theora_tpu_torch.ops.idct_cuda", "dequantize_idct_frames",
            ("dequant_idct_kernel",),
            lambda a: bounds.k1_bound("decode", a)),
    "KL": ("theora_tpu_torch.ops.loopfilter_cuda", "loop_filter_plane",
           ("loop_filter_kernel",), bounds.kl_bound),
    "KS": ("theora_tpu_torch.ops.mc_cuda", "mc_recon", ("mc_recon_kernel",),
           lambda a: bounds.ks_bound("mc_recon", a)),
    "KSp": ("theora_tpu_torch.ops.mc_cuda", "place_rows", ("place_kernel",),
            lambda a: bounds.ks_bound("place_rows", a)),
}

_IDENT = re.compile(r"([A-Za-z_][A-Za-z0-9_]*)\s*[<(]")


def kernel_of(device_op: str) -> str | None:
    """The KERNELS key of a device op's name, None for any other op."""
    m = _IDENT.search(device_op.replace("void ", "", 1))
    name = m.group(1) if m else device_op
    for key, (_, _, names, _) in KERNELS.items():
        if name in names:
            return key
    return None


def record_bounds(fn) -> dict:
    """fn() once with each wrapper replaced by one that calls it and then
    adds the bound of its arguments; {key: [bound seconds, calls]}. The
    wrappers are restored after."""
    out: dict = {}
    saved = []

    def recorder(key, real, bound):
        sig = inspect.signature(real)

        def call(*args, **kwargs):
            res = real(*args, **kwargs)
            ba = sig.bind(*args, **kwargs)
            ba.apply_defaults()
            b = bound(tuple(ba.arguments.values()))
            acc = out.setdefault(key, [0.0, 0])
            acc[0] += b["bound_ms"] / 1e3
            acc[1] += 1
            return res

        call.launches = 0
        return call

    try:
        for key, (modname, attr, _, bound) in KERNELS.items():
            try:
                mod = importlib.import_module(modname)
                real = getattr(mod, attr)
            except (ImportError, AttributeError):
                continue
            saved.append((mod, attr, real))
            setattr(mod, attr, recorder(key, real, bound))
        fn()
    finally:
        for mod, attr, real in saved:
            setattr(mod, attr, real)
    return out
