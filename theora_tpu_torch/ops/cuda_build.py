"""Build a hand-written CUDA kernel's source into a shared library.

Each kernel (csrc/*.cu) has a plain C interface and is compiled with nvcc
for sm_90a at first use into the git-ignored ``csrc/build/``, then bound
with ctypes by its wrapper (ops/idct_cuda.py, ops/fdct_cuda.py,
ops/trellis_cuda.py, ops/qrd_cuda.py, ops/me_cuda.py,
ops/loopfilter_cuda.py, ops/mc_cuda.py, ops/postproc_cuda.py). A failed
build raises.
"""
from __future__ import annotations

import os
import shutil
import subprocess
import tempfile


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is required "
                           "to build the port's kernels")
    return path


def nvcc_build(src: str, so: str, flags: tuple[str, ...] = (),
               deps: tuple[str, ...] = ()) -> str:
    """Compile src into so when so is missing or older than src or any of
    deps (the headers src includes); returns so. flags are the source's
    own nvcc options, added to the common ones. ptxas' report (registers,
    shared memory and spills of each kernel) is kept beside it as so +
    ".log". Concurrent builders each write a private file and rename it
    into place."""
    if os.path.exists(so) and all(
            os.path.getmtime(so) >= os.path.getmtime(f)
            for f in (src, *deps)):
        return so
    os.makedirs(os.path.dirname(so), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(so))
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
             "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
             "-Xptxas", "-v", *flags, "-o", tmp, src],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr}")
        with open(so + ".log", "w") as f:
            f.write(proc.stderr)
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so
