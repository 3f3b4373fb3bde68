"""PyTorch/CUDA port of theora_tpu's device tier, for one NVIDIA H100.

Two slices: the GOP-batch decoder (``decode/batch.py``), whose dequant +
iDCT runs as a hand-written CUDA kernel (``csrc/idct.cu``), and the
device GOP encoder (``encode/gop.py``), whose fDCT + quantizer is a second
one (``csrc/fdct_quant.cu``) and whose reconstruction reuses the first.
The package imports neither JAX nor ``theora_tpu``: it keeps its own
copies of the host modules it needs (headers, geometry, tables, the
native entropy tier, ...), each trimmed to what the slices use.

Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU with ``device="cpu"``. Without a card they raise; they never
carry on on the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The torch device an entry point runs on. ``cuda`` without a
    visible card raises; the CPU is used only when asked for."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain PyTorch path on the CPU"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
