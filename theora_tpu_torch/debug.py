"""Debug and tracing utilities.

Port of theora_tpu/debug.py:

- ``THEORA_TPU_DEBUG=1`` (read at import) arms wraparound assertions in
  the plain integer transforms: the codec's int16 stores are explicit
  wraps (`ops/transforms._i16`), which on a legal stream are the identity,
  so a wrap that changes a value means out-of-spec data or a bug. On a
  CUDA tensor the comparison runs on the card and costs one
  synchronisation per wrap site, and only while the flag is armed. The
  hand-written kernels (csrc/) are not instrumented, as the JAX package's
  Pallas bodies are not (they use their own wrap, pallas_kernels.py:36):
  the check covers the plain versions, which are the kernels' oracles.
- `named_scope(name)` labels a stage in profiler traces
  (`torch.profiler.record_function`), and `trace(logdir)` records a
  `torch.profiler` trace of its block into ``logdir/trace.json`` (Chrome
  trace format; open it in Perfetto or chrome://tracing).
"""
from __future__ import annotations

import contextlib
import os

import torch

DEBUG = os.environ.get("THEORA_TPU_DEBUG", "") not in ("", "0")


def named_scope(name: str):
    """A context manager that labels its block `name` in profiler
    traces."""
    return torch.profiler.record_function(name)


def check_wrap(wrapped: torch.Tensor, original: torch.Tensor,
               where: str) -> torch.Tensor:
    """Debug-mode assertion that an int16 wraparound was the identity.

    Returns `wrapped` unchanged; with THEORA_TPU_DEBUG=1 it raises
    OverflowError when any element actually wrapped. Costs nothing when
    the flag is off."""
    if not DEBUG:
        return wrapped
    bad = wrapped != original
    if bool(bad.any()):
        idx = tuple(int(i[0]) for i in torch.nonzero(bad, as_tuple=True))
        raise OverflowError(
            f"{where}: int16 overflow at {idx}: {int(original[idx])} "
            f"wrapped to {int(wrapped[idx])} (out-of-spec input or kernel "
            "bug)")
    return wrapped


@contextlib.contextmanager
def trace(logdir: str):
    """Record a torch.profiler trace of the block (the CPU, and the card
    when one is visible) and write it to logdir/trace.json."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
