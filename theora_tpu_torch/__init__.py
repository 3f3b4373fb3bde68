"""PyTorch/CUDA port of theora_tpu's device tier, for one NVIDIA H100.

The decoders: the GOP-batch decoder (``decode/batch.py``) and the
per-packet decoder on its references (``decode/scalar.py``), with the
host decoder's controls: the postprocessor (pp levels 1-7), telemetry
overlays, the striped-decode callback, and the ``th_*`` decode API over
them (``compat.py``, with its encode half over the host encoder and the
pre-1.0 ``theora_*`` API over both). The device GOP encoder
(``encode/gop.py``) with every setting of the JAX one (speed levels,
adaptive quantization, scene cuts, CBR, 2-pass), its three stages and
the device-resident transcode; the mesh GOP encoder
(``parallel/gop.py``), which runs a batch of GOPs side by side on one
card, and over torch.distributed ranks, one per device, splits the
batch's GOPs and each frame's fragments between them
(``parallel/ranks.py``); the all-keyframe batch encoder
(``encode/intra.py``); and the host encoder (``encode/encoder.py``),
whose closed loop decodes on the card, with the GOP-parallel transcodes
over it (``parallel/transcode.py``, ``parallel/distributed.py``). Their
hand-written CUDA kernels (``csrc/``): K1, dequant + iDCT (the decode's,
and the encode's through reconstruction and the qi chooser); K2, fDCT +
quantization; KT, the trellis; KR, the R/D quantizer; KM, the ME plan;
KL, the loop filter; KS, MC and the plane's assembly; KP, the decoder's
postprocessor (deblock + dering). The package imports neither JAX nor
``theora_tpu``: it keeps its own copies of the host modules it needs
(headers, geometry, tables, the native entropy tier, rate control, ...),
each trimmed to what the port uses.

Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU with ``device="cpu"``. Without a card they raise; they never
carry on on the CPU.
"""
from __future__ import annotations

import torch

__version__ = "0.1.0"


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
