"""Guards of the PyTorch port: it imports neither JAX nor the JAX
package (nor do the testdata scripts chip_smoke.py runs, at import), it
never falls back to the CPU when a card is missing, the
kernel wrappers (K1, K2, KT) take their plain paths only for CPU tensors,
KT is built without floating-point contraction, and the encoder settings
it does not carry yet raise."""
import ast
import os

import numpy as np
import pytest
import torch

from tests.conftest import REPO_ROOT, TESTDATA
from theora_tpu_torch.ops import idct_cuda, transforms

FORBIDDEN = ("jax", "jaxlib", "theora_tpu")


def _port_sources():
    root = os.path.join(REPO_ROOT, "theora_tpu_torch")
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(REPO_ROOT, "chip_smoke.py")


def _parse(path):
    with open(path) as f:
        return ast.parse(f.read(), path)


def _imports_of(nodes):
    for node in nodes:
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", None) == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def _imported_modules(path):
    yield from _imports_of(ast.walk(_parse(path)))


def _import_time_nodes(tree):
    """The nodes that run when the module is executed: everything but
    the bodies of functions and lambdas."""
    todo = [tree]
    while todo:
        node = todo.pop()
        yield node
        todo.extend(n for n in ast.iter_child_nodes(node)
                    if not isinstance(n, (ast.FunctionDef,
                                          ast.AsyncFunctionDef, ast.Lambda)))


def _smoke_scripts():
    """The testdata scripts chip_smoke.py executes by path, followed
    through the scripts they load in turn (a '<name>.py' string constant
    naming a file of testdata/)."""
    found = []
    tree = _parse(os.path.join(REPO_ROOT, "chip_smoke.py"))
    todo = [n.args[0].value for n in ast.walk(tree)
            if isinstance(n, ast.Call)
            and getattr(n.func, "id", None) == "_load_testdata"]
    while todo:
        name = todo.pop()
        path = os.path.join(TESTDATA, name if name.endswith(".py")
                            else f"{name}.py")
        if path in found:
            continue
        found.append(path)
        todo += [n.value for n in ast.walk(_parse(path))
                 if isinstance(n, ast.Constant) and isinstance(n.value, str)
                 and n.value.endswith(".py")
                 and os.path.exists(os.path.join(TESTDATA, n.value))]
    return found


def test_port_imports_no_jax_and_no_jax_package():
    sources = list(_port_sources())
    assert len(sources) > 10
    bad = []
    for path in sources:
        for mod in _imported_modules(path):
            if mod.split(".")[0] in FORBIDDEN:
                bad.append((os.path.relpath(path, REPO_ROOT), mod))
    assert not bad, bad


def test_smoke_scripts_import_no_jax_when_loaded():
    scripts = _smoke_scripts()
    names = sorted(os.path.basename(p) for p in scripts)
    assert names == ["make_hd720.py", "make_hd720_enc.py"]
    bad = [(os.path.basename(path), mod) for path in scripts
           for mod in _imports_of(_import_time_nodes(_parse(path)))
           if mod.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_batch_decoder_without_card_raises(monkeypatch):
    from theora_tpu_torch.decode.batch import BatchDecoder
    from theora_tpu_torch.headers import parse_info_header, \
        parse_setup_header
    from theora_tpu_torch.tpkt import read_tpkt

    pkts = read_tpkt(os.path.join(TESTDATA, "clip64x48_k8_q5.tpkt"))
    info = parse_info_header(pkts[0].data)
    setup = parse_setup_header(pkts[2].data)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchDecoder(info, setup)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchDecoder(info, setup, device="cuda")
    assert BatchDecoder(info, setup, device="cpu").device.type == "cpu"


def _k1_args(device):
    n = 5
    return (
        torch.zeros((n, 64), dtype=torch.int16, device=device),
        torch.zeros(n, dtype=torch.int16, device=device),
        torch.ones((1, 3, 2, 64), dtype=torch.int16, device=device),
        torch.zeros(n, dtype=torch.int32, device=device),
        torch.zeros(n, dtype=torch.uint8, device=device),
        torch.zeros(n, dtype=torch.uint8, device=device),
        torch.zeros(n, dtype=torch.bool, device=device),
    )


def test_k1_plain_path_only_for_cpu_tensors(monkeypatch):
    calls = []

    def plain(*args):
        calls.append(args[0].device.type)
        return torch.zeros((args[0].shape[0], 64), dtype=torch.int16)

    monkeypatch.setattr(transforms, "dequantize_idct_frames", plain)
    idct_cuda.dequantize_idct_frames(*_k1_args("cpu"))
    assert calls == ["cpu"]
    # A tensor on any other device never reaches the plain version.
    with pytest.raises(ValueError, match="unsupported device"):
        idct_cuda.dequantize_idct_frames(*_k1_args("meta"))
    assert calls == ["cpu"]


@pytest.mark.parametrize("which,bad", [
    (0, torch.zeros((5, 64), dtype=torch.int32)),
    (0, torch.zeros((5, 63), dtype=torch.int16)),
    (0, torch.zeros((64, 5), dtype=torch.int16).t()),
    (2, torch.ones((1, 2, 2, 64), dtype=torch.int16)),
    (3, torch.zeros(5, dtype=torch.int64)),
    (6, torch.zeros(5, dtype=torch.uint8)),
])
def test_k1_wrapper_rejects_what_the_kernel_does_not_take(which, bad):
    args = list(_k1_args("cpu"))
    args[which] = bad
    with pytest.raises((TypeError, ValueError)):
        idct_cuda.dequantize_idct_frames(*args)


def test_k1_wrapper_output_on_cpu():
    out = idct_cuda.dequantize_idct_frames(*_k1_args("cpu"))
    assert out.dtype == torch.int16 and out.shape == (5, 64)
    assert np.array_equal(out.numpy(), np.zeros((5, 64), np.int16))


# ------------------------------------------------------------- encode side

def _small_info():
    from theora_tpu_torch.info import TheoraInfo

    return TheoraInfo(frame_width=64, frame_height=48, pic_width=64,
                      pic_height=48, quality=40)


def test_gop_encoder_without_card_raises(monkeypatch):
    from theora_tpu_torch.encode.gop import GopEncoder

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GopEncoder(_small_info())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GopEncoder(_small_info(), device="cuda")
    assert GopEncoder(_small_info(), device="cpu").device.type == "cpu"


@pytest.mark.parametrize("setting", [
    dict(adaptive_quant=True), dict(adaptive_quant="auto"),
    dict(use_trellis=False), dict(target_bitrate=200000),
    dict(auto_keyframe=True), dict(attribute="adaptive_quant"),
])
def test_unsupported_settings_raise(setting):
    from theora_tpu_torch.encode.gop import GopEncoder

    frames = [[np.zeros((48, 64), np.uint8), np.zeros((24, 32), np.uint8),
               np.zeros((24, 32), np.uint8)]]
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        if "attribute" in setting:
            GopEncoder(_small_info(), device="cpu").adaptive_quant = "auto"
        elif set(setting) <= {"adaptive_quant", "use_trellis"}:
            GopEncoder(_small_info(), device="cpu", **setting)
        else:
            GopEncoder(_small_info(), device="cpu").encode_clip(frames,
                                                                **setting)


def _k2_args(device):
    n = 5
    return (
        torch.zeros((n, 64), dtype=torch.int16, device=device),
        torch.full((2, 64), 8, dtype=torch.int16, device=device),
        torch.zeros(n, dtype=torch.uint8, device=device),
    )


def test_k2_plain_path_only_for_cpu_tensors(monkeypatch):
    from theora_tpu_torch.ops import fdct_cuda

    calls = []

    def plain(*args):
        calls.append(args[0].device.type)
        z = torch.zeros((args[0].shape[0], 64), dtype=torch.int16)
        return z, z

    monkeypatch.setattr(transforms, "fdct_quantize", plain)
    fdct_cuda.fdct_quantize(*_k2_args("cpu"))
    assert calls == ["cpu"]
    with pytest.raises(ValueError, match="unsupported device"):
        fdct_cuda.fdct_quantize(*_k2_args("meta"))
    assert calls == ["cpu"]


@pytest.mark.parametrize("which,bad", [
    (0, torch.zeros((5, 64), dtype=torch.int32)),
    (0, torch.zeros((5, 63), dtype=torch.int16)),
    (0, torch.zeros((64, 5), dtype=torch.int16).t()),
    (1, torch.full((3, 64), 8, dtype=torch.int16)),
    (1, torch.full((2, 64), 8, dtype=torch.int32)),
    (2, torch.zeros(5, dtype=torch.bool)),
    (2, torch.zeros(4, dtype=torch.uint8)),
])
def test_k2_wrapper_rejects_what_the_kernel_does_not_take(which, bad):
    from theora_tpu_torch.ops import fdct_cuda

    args = list(_k2_args("cpu"))
    args[which] = bad
    with pytest.raises((TypeError, ValueError)):
        fdct_cuda.fdct_quantize(*args)


def test_k2_wrapper_output_on_cpu():
    from theora_tpu_torch.ops import fdct_cuda

    q, d = fdct_cuda.fdct_quantize(*_k2_args("cpu"))
    assert q.dtype == d.dtype == torch.int16
    assert q.shape == d.shape == (5, 64)
    assert fdct_cuda.fdct_quantize.launches == 0


# ------------------------------------------------------------- kernel KT

def _kt_args(device):
    n = 5
    return (
        torch.zeros((n, 64), dtype=torch.int16, device=device),
        torch.zeros((n, 64), dtype=torch.int16, device=device),
        torch.full((2, 64), 8, dtype=torch.int16, device=device),
        torch.zeros(n, dtype=torch.uint8, device=device),
        np.float32(100.0),
        torch.ones((64, 32), dtype=torch.float32, device=device),
    )


def test_kt_plain_path_only_for_cpu_tensors(monkeypatch):
    from theora_tpu_torch.ops import trellis_cuda

    calls = []

    def plain(*args):
        calls.append(args[0].device.type)
        n = args[0].shape[0]
        return (torch.zeros((n, 64), dtype=torch.int16),
                torch.zeros(n, dtype=torch.int32),
                torch.ones(n, dtype=torch.bool))

    monkeypatch.setattr(transforms, "trellis_quantize", plain)
    trellis_cuda.trellis_quantize(*_kt_args("cpu"))
    assert calls == ["cpu"]
    with pytest.raises(ValueError, match="unsupported device"):
        trellis_cuda.trellis_quantize(*_kt_args("meta"))
    assert calls == ["cpu"]
    assert trellis_cuda.trellis_quantize.launches == 0


@pytest.mark.parametrize("which,bad", [
    (0, torch.zeros((5, 64), dtype=torch.int32)),
    (0, torch.zeros((5, 63), dtype=torch.int16)),
    (0, torch.zeros((64, 5), dtype=torch.int16).t()),
    (1, torch.zeros((4, 64), dtype=torch.int16)),
    (1, torch.zeros((5, 64), dtype=torch.int32)),
    (1, torch.zeros((5, 64), dtype=torch.int16, device="meta")),
    (1, torch.zeros(5 * 64 + 1, dtype=torch.int16)[1:].view(5, 64)),
    (2, torch.full((5, 64), 8, dtype=torch.int16)),
    (2, torch.full((2, 64), 8, dtype=torch.int32)),
    (2, torch.full((64, 2), 8, dtype=torch.int16).t()),
    (3, torch.zeros(5, dtype=torch.bool)),
    (3, torch.zeros(6, dtype=torch.uint8)),
    (3, torch.zeros(5, dtype=torch.uint8, device="meta")),
    (4, float("nan")),
    (4, float("inf")),
    (4, -1.0),
    (4, 100),
    (4, torch.tensor(100.0)),
    (5, torch.ones((32, 64), dtype=torch.float32).t()),
    (5, torch.ones((64, 31), dtype=torch.float32)),
    (5, torch.ones((64, 32), dtype=torch.float16)),
])
def test_kt_wrapper_rejects_what_the_kernel_does_not_take(which, bad):
    from theora_tpu_torch.ops import trellis_cuda

    args = list(_kt_args("cpu"))
    args[which] = bad
    with pytest.raises((TypeError, ValueError)):
        trellis_cuda.trellis_quantize(*args)


def test_kt_build_is_sm90a_without_contraction(monkeypatch, tmp_path):
    """KT's library is built by nvcc_build from csrc/trellis.cu for
    sm_90a with -fmad=false (its float32 sums must not fuse) and without
    fast math. Nothing is compiled: subprocess.run is replaced."""
    import subprocess

    from theora_tpu_torch.ops import cuda_build, trellis_cuda

    calls = []

    def run(cmd, **kwargs):
        calls.append(cmd)
        return subprocess.CompletedProcess(cmd, 0, "", "ptxas info")

    monkeypatch.setattr(cuda_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(subprocess, "run", run)
    monkeypatch.setattr(trellis_cuda, "_SO",
                        str(tmp_path / "build" / "libtheora_trellis.so"))
    so = trellis_cuda.build()
    assert len(calls) == 1
    cmd = calls[0]
    assert cmd[0] == "nvcc"
    assert cmd[cmd.index("-gencode") + 1] == "arch=compute_90a,code=sm_90a"
    assert "-fmad=false" in cmd
    assert not any("fast_math" in c or "fast-math" in c for c in cmd)
    assert cmd[-1] == trellis_cuda._SRC
    assert cmd[-1].endswith(os.path.join("csrc", "trellis.cu"))
    assert so == trellis_cuda._SO and os.path.exists(so)
    with open(so + ".log") as f:
        assert f.read() == "ptxas info"


def test_kt_wrapper_output_on_cpu():
    from theora_tpu_torch.ops import trellis_cuda

    vals, cnt, dc_only = trellis_cuda.trellis_quantize(*_kt_args("cpu"))
    assert vals.dtype == torch.int16 and vals.shape == (5, 64)
    assert cnt.dtype == torch.int32 and cnt.shape == (5,)
    assert dc_only.dtype == torch.bool and dc_only.shape == (5,)
    assert not vals.any() and not cnt.any() and dc_only.all()
    assert trellis_cuda.trellis_quantize.launches == 0
