"""PyTorch/CUDA port of theora_tpu's device tier, for one NVIDIA H100.

The first slice is the GOP-batch decoder (``decode/batch.py``), whose
dequant + iDCT runs as a hand-written CUDA kernel (``csrc/idct.cu``).
The package imports neither JAX nor ``theora_tpu``: it keeps its own
copies of the host modules it needs (headers, geometry, the native
entropy tier, ...), each trimmed to the decode side.

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
