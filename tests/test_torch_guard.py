"""Guards of the PyTorch port: it imports neither JAX nor the JAX
package (nor do the testdata scripts chip_smoke.py runs, at import), it
never falls back to the CPU when a card is missing, the
kernel wrappers (K1 at both entries, K2, KT, KR) take their plain paths
only for CPU tensors and K1's have no fallback, K1, KT and KR are built
without floating-point contraction, and the encoder takes every setting of
the JAX encoder, with its defaults, and its stages and the device
transcode take JAX's signatures."""
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


def _k1r_args(device, k=1, n=5):
    """Arguments of K1's encode entry (idct_recon_choose) at k rows."""
    return (
        torch.zeros((k, n, 64), dtype=torch.int16, device=device),
        torch.ones((k, n), dtype=torch.bool, device=device),
        torch.zeros((k, n), dtype=torch.int32, device=device),
        torch.full((k, 2, 64), 8, dtype=torch.int16, device=device),
        torch.zeros(n, dtype=torch.uint8, device=device),
        torch.full((n, 64), 128, dtype=torch.int32, device=device),
        torch.full((n, 64), 130, dtype=torch.uint8, device=device),
        torch.tensor(100.0, dtype=torch.float32, device=device),
        None,
    )


def test_k1_encode_entry_plain_path_only_for_cpu_tensors(monkeypatch):
    calls = []

    def plain(*args):
        calls.append(args[0].device.type)
        n = args[0].shape[1]
        return (torch.zeros((n, 64), dtype=torch.uint8),
                torch.zeros(n, dtype=torch.int32),
                torch.zeros(n, dtype=torch.uint8),
                torch.zeros((n, 64), dtype=torch.int16),
                torch.zeros(n, dtype=torch.int32))

    monkeypatch.setattr(transforms, "idct_recon_choose", plain)
    idct_cuda.idct_recon_choose(*_k1r_args("cpu", 3))
    assert calls == ["cpu"]
    # A tensor on any other device never reaches the plain version.
    with pytest.raises(ValueError, match="unsupported device"):
        idct_cuda.idct_recon_choose(*_k1r_args("meta", 3))
    assert calls == ["cpu"]
    assert idct_cuda.idct_recon_choose.launches == 0


@pytest.mark.parametrize("which,bad", [
    (0, torch.zeros((5, 64), dtype=torch.int16)),
    (0, torch.zeros((4, 5, 64), dtype=torch.int16)),
    (0, torch.zeros((1, 5, 64), dtype=torch.int32)),
    (0, torch.zeros((1, 5, 63), dtype=torch.int16)),
    (0, torch.zeros((1, 64, 5), dtype=torch.int16).transpose(1, 2)),
    (0, torch.zeros(5 * 64 + 1, dtype=torch.int16)[1:].view(1, 5, 64)),
    (0, torch.zeros((1, 5, 64), dtype=torch.int16, device="meta")),
    (1, torch.ones((1, 5), dtype=torch.uint8)),
    (1, torch.ones((1, 4), dtype=torch.bool)),
    (2, torch.zeros((1, 5), dtype=torch.int64)),
    (2, torch.zeros((2, 5), dtype=torch.int32)),
    (3, torch.full((2, 64), 8, dtype=torch.int16)),
    (3, torch.full((1, 2, 64), 8, dtype=torch.int32)),
    (3, torch.full((2, 2, 64), 8, dtype=torch.int16)),
    (4, torch.zeros(5, dtype=torch.bool)),
    (4, torch.zeros(6, dtype=torch.uint8)),
    (5, torch.zeros((5, 64), dtype=torch.int16)),
    (5, torch.zeros((5, 8, 8), dtype=torch.int32)),
    (5, torch.zeros(5 * 64 + 1, dtype=torch.int32)[1:].view(5, 64)),
    (6, torch.zeros((5, 64), dtype=torch.int32)),
    (6, torch.zeros((64, 5), dtype=torch.uint8).t()),
    (6, torch.zeros(5 * 64 + 1, dtype=torch.uint8)[1:].view(5, 64)),
    (6, torch.zeros((5, 64), dtype=torch.uint8, device="meta")),
    (7, torch.tensor([100.0])),
    (7, torch.tensor(100.0, dtype=torch.float64)),
    (7, torch.tensor(100.0, device="meta")),
    (8, torch.ones(4, dtype=torch.float32)),
    (8, torch.ones(5, dtype=torch.float64)),
    (8, torch.ones(5, dtype=torch.float32, device="meta")),
])
def test_k1_encode_entry_rejects_what_the_kernel_does_not_take(which, bad):
    args = list(_k1r_args("cpu"))
    args[which] = bad
    with pytest.raises((TypeError, ValueError)):
        idct_cuda.idct_recon_choose(*args)


def test_k1_encode_entry_output_on_cpu():
    for k in (1, 3):
        recon, ssd, qii, q, cnt = idct_cuda.idct_recon_choose(
            *_k1r_args("cpu", k))
        assert recon.dtype == qii.dtype == torch.uint8
        assert ssd.dtype == cnt.dtype == torch.int32
        assert q.dtype == torch.int16
        assert recon.shape == q.shape == (5, 64)
        assert ssd.shape == qii.shape == cnt.shape == (5,)
        # Zero values leave the prediction, 2 below the source everywhere.
        assert (recon == 128).all() and (ssd == 64 * 4).all()
        assert not qii.any()
    assert idct_cuda.idct_recon_choose.launches == 0


def test_k1_wrappers_have_no_fallback():
    """Neither K1 wrapper catches an error to fall back to the plain
    version: idct_cuda has no try statement."""
    tree = _parse(idct_cuda.__file__)
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)]


def test_k1_build_is_sm90a_without_contraction(monkeypatch, tmp_path):
    """K1's library is built by nvcc_build from csrc/idct.cu for sm_90a
    with -fmad=false (the chooser's float32 costs must not fuse) and
    without fast math. Nothing is compiled: subprocess.run is replaced."""
    import subprocess

    from theora_tpu_torch.ops import cuda_build

    calls = []

    def run(cmd, **kwargs):
        calls.append(cmd)
        return subprocess.CompletedProcess(cmd, 0, "", "ptxas info")

    monkeypatch.setattr(cuda_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(subprocess, "run", run)
    monkeypatch.setattr(idct_cuda, "_SO",
                        str(tmp_path / "build" / "libtheora_idct.so"))
    so = idct_cuda.build()
    assert len(calls) == 1
    cmd = calls[0]
    assert cmd[0] == "nvcc"
    assert cmd[cmd.index("-gencode") + 1] == "arch=compute_90a,code=sm_90a"
    assert "-fmad=false" in cmd
    assert not any("fast_math" in c or "fast-math" in c for c in cmd)
    assert cmd[-1] == idct_cuda._SRC
    assert cmd[-1].endswith(os.path.join("csrc", "idct.cu"))
    assert so == idct_cuda._SO and os.path.exists(so)


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


def test_encoder_settings_that_are_ported():
    """adaptive_quant takes False, True and "auto" (the default) and
    nothing else; rd_strength and use_trellis are constructor arguments;
    speed levels 0-4, clipped to that range, set the quantizer (the
    trellis at 0-1) and, at 4, the mode decision without motion
    compensation, as TpuGopEncoder.set_splevel does; encode_clip's
    rate_window defaults to 8, as in JAX."""
    import inspect

    from theora_tpu.encode.tpu_gop import TpuGopEncoder
    from theora_tpu_torch.encode.gop import GopEncoder

    enc = GopEncoder(_small_info(), device="cpu")
    assert enc.adaptive_quant == "auto" and enc.rd_strength == 3.0
    for mode in (False, True, "auto"):
        enc.adaptive_quant = mode
        assert enc.adaptive_quant is mode
    for bad in ("on", 1, None, "Auto"):
        with pytest.raises(ValueError, match="adaptive_quant"):
            enc.adaptive_quant = bad
        with pytest.raises(ValueError, match="adaptive_quant"):
            GopEncoder(_small_info(), device="cpu", adaptive_quant=bad)
    assert GopEncoder(_small_info(), device="cpu",
                      rd_strength=1.5).rd_strength == 1.5
    assert enc.use_trellis is True and enc.sp_level == 0
    assert GopEncoder(_small_info(), device="cpu",
                      use_trellis=False).use_trellis is False
    for lvl in (-1, 0, 1, 2, 3, 4, 7):
        enc.set_splevel(lvl)
        assert (enc.sp_level, enc.use_trellis, enc._no_mc) == (
            min(max(lvl, 0), 4), lvl < 2, lvl >= 4)
    for fn in ("encode_clip", "encode_clip_pass1", "encode_clip_pass2",
               "encode_clip_twopass"):
        ours = inspect.signature(getattr(GopEncoder, fn)).parameters
        ref = inspect.signature(getattr(TpuGopEncoder, fn)).parameters
        assert {k: v.default for k, v in ours.items()} == \
            {k: v.default for k, v in ref.items()}, fn


def test_stages_and_transcode_take_the_jax_signatures():
    """The encoder's stages and the device transcode take JAX's
    parameters with JAX's defaults (the device rides enc_kwargs)."""
    import inspect

    from theora_tpu.encode import tpu_gop
    from theora_tpu_torch.encode import gop

    def params(fn):
        return {k: v.default
                for k, v in inspect.signature(fn).parameters.items()}

    for fn in ("dispatch_me", "complete_dispatch", "finish_gop",
               "dispatch_gop", "encode_gop"):
        assert params(getattr(gop.GopEncoder, fn)) == \
            params(getattr(tpu_gop.TpuGopEncoder, fn)), fn
    assert params(gop.transcode_device) == params(tpu_gop.transcode_device)


def _k2_args(device):
    n = 5
    return (
        torch.zeros((n, 64), dtype=torch.int16, device=device),
        torch.full((1, 2, 64), 8, dtype=torch.int16, device=device),
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
    fdct_cuda.fdct_quantize(*_k2_args("cpu")[:1],
                            torch.full((3, 2, 64), 8, dtype=torch.int16),
                            *_k2_args("cpu")[2:])
    assert calls == ["cpu", "cpu"]
    calls.pop()
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
    (1, torch.full((4, 2, 64), 8, dtype=torch.int16)),
    (1, torch.full((0, 2, 64), 8, dtype=torch.int16)),
    (1, torch.full((1, 2, 64), 8, dtype=torch.int32)),
    (1, torch.full((1, 3, 64), 8, dtype=torch.int16)),
    (0, torch.zeros(5 * 64 + 1, dtype=torch.int16)[1:].view(5, 64)),
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
    assert q.shape == (1, 5, 64) and d.shape == (5, 64)
    q3, _ = fdct_cuda.fdct_quantize(
        _k2_args("cpu")[0], torch.full((3, 2, 64), 8, dtype=torch.int16),
        _k2_args("cpu")[2])
    assert q3.shape == (3, 5, 64)
    assert fdct_cuda.fdct_quantize.launches == 0


# ------------------------------------------------------------- kernel KT

def _kt_args(device):
    n = 5
    return (
        torch.zeros((1, n, 64), dtype=torch.int16, device=device),
        torch.zeros((n, 64), dtype=torch.int16, device=device),
        torch.full((1, 2, 64), 8, dtype=torch.int16, device=device),
        torch.zeros(n, dtype=torch.uint8, device=device),
        torch.tensor([100.0], device=device),
        torch.ones((64, 32), dtype=torch.float32, device=device),
        None,
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
    (0, torch.zeros((4, 5, 64), dtype=torch.int16)),
    (0, torch.zeros((2, 5, 64), dtype=torch.int16)),
    (2, torch.full((2, 2, 64), 8, dtype=torch.int16)),
    (4, np.array([float("nan")], np.float32)),
    (4, np.array([-1.0], np.float32)),
    (4, np.array([100.0], np.float64)),
    (4, np.array([100.0, 100.0], np.float32)),
    (4, np.float32(100.0)),
    (4, torch.tensor([100.0], dtype=torch.float64)),
    (4, torch.tensor([100.0, 100.0])),
    (4, torch.tensor([100.0], device="meta")),
    (6, torch.ones(4, dtype=torch.float32)),
    (6, torch.ones(5, dtype=torch.float64)),
    (6, torch.ones(5, dtype=torch.float32, device="meta")),
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
    assert vals.dtype == torch.int16 and vals.shape == (1, 5, 64)
    assert cnt.dtype == torch.int32 and cnt.shape == (1, 5)
    assert dc_only.dtype == torch.bool and dc_only.shape == (1, 5)
    assert not vals.any() and not cnt.any() and dc_only.all()
    args = list(_kt_args("cpu"))
    args[0] = torch.zeros((3, 5, 64), dtype=torch.int16)
    args[2] = torch.full((3, 2, 64), 8, dtype=torch.int16)
    args[4] = torch.tensor([1.0, 2.0, 3.0])
    args[6] = torch.full((5,), 0.5)
    vals, cnt, dc_only = trellis_cuda.trellis_quantize(*args)
    assert vals.shape == (3, 5, 64) and cnt.shape == dc_only.shape == (3, 5)
    assert trellis_cuda.trellis_quantize.launches == 0


# ------------------------------------------------------------- kernel KR

def _kr_args(device):
    n = 5
    return (
        torch.zeros((1, n, 64), dtype=torch.int16, device=device),
        torch.zeros((n, 64), dtype=torch.int16, device=device),
        torch.full((1, 2, 64), 8, dtype=torch.int16, device=device),
        torch.zeros(n, dtype=torch.uint8, device=device),
        torch.tensor([[10.0, 12.0]], device=device),
    )


def test_kr_plain_path_only_for_cpu_tensors(monkeypatch):
    from theora_tpu_torch.ops import qrd_cuda

    calls = []

    def plain(*args):
        calls.append(args[0].device.type)
        n = args[0].shape[1]
        return (torch.zeros((1, n, 64), dtype=torch.int16),
                torch.zeros((1, n), dtype=torch.int32),
                torch.ones((1, n), dtype=torch.bool))

    monkeypatch.setattr(transforms, "quantize_rd_rows", plain)
    qrd_cuda.quantize_rd(*_kr_args("cpu"))
    assert calls == ["cpu"]
    with pytest.raises(ValueError, match="unsupported device"):
        qrd_cuda.quantize_rd(*_kr_args("meta"))
    assert calls == ["cpu"]
    assert qrd_cuda.quantize_rd.launches == 0


@pytest.mark.parametrize("which,bad", [
    (0, torch.zeros((5, 64), dtype=torch.int16)),
    (0, torch.zeros((1, 5, 64), dtype=torch.int32)),
    (0, torch.zeros((4, 5, 64), dtype=torch.int16)),
    (0, torch.zeros((1, 64, 5), dtype=torch.int16).transpose(1, 2)),
    (0, torch.zeros(5 * 64 + 1, dtype=torch.int16)[1:].view(1, 5, 64)),
    (1, torch.zeros((4, 64), dtype=torch.int16)),
    (1, torch.zeros((5, 64), dtype=torch.int32)),
    (1, torch.zeros((5, 64), dtype=torch.int16, device="meta")),
    (1, torch.zeros(5 * 64 + 1, dtype=torch.int16)[1:].view(5, 64)),
    (2, torch.full((2, 64), 8, dtype=torch.int16)),
    (2, torch.full((2, 2, 64), 8, dtype=torch.int16)),
    (2, torch.full((1, 2, 64), 8, dtype=torch.int32)),
    (3, torch.zeros(5, dtype=torch.bool)),
    (3, torch.zeros(6, dtype=torch.uint8)),
    (4, np.array([10.0, 12.0], np.float32)),
    (4, np.array([[10.0, 12.0]], np.float64)),
    (4, np.array([[10.0, np.nan]], np.float32)),
    (4, np.array([[10.0, -1.0]], np.float32)),
    (4, np.array([[10.0, 12.0], [1.0, 2.0]], np.float32)),
    (4, torch.tensor([[10.0, 12.0]], dtype=torch.float64)),
    (4, torch.tensor([10.0, 12.0])),
    (4, torch.tensor([[10.0, 12.0]], device="meta")),
    (4, torch.tensor([0.0, 10.0, 12.0])[1:].view(1, 2)),
    (4, 10.0),
])
def test_kr_wrapper_rejects_what_the_kernel_does_not_take(which, bad):
    from theora_tpu_torch.ops import qrd_cuda

    args = list(_kr_args("cpu"))
    args[which] = bad
    with pytest.raises((TypeError, ValueError)):
        qrd_cuda.quantize_rd(*args)


def test_kr_build_is_sm90a_without_contraction(monkeypatch, tmp_path):
    """KR's library is built by nvcc_build from csrc/quantize_rd.cu for
    sm_90a with -fmad=false (only its explicit fused multiply-adds may
    fuse) and without fast math. Nothing is compiled: subprocess.run is
    replaced."""
    import subprocess

    from theora_tpu_torch.ops import cuda_build, qrd_cuda

    calls = []

    def run(cmd, **kwargs):
        calls.append(cmd)
        return subprocess.CompletedProcess(cmd, 0, "", "ptxas info")

    monkeypatch.setattr(cuda_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(subprocess, "run", run)
    monkeypatch.setattr(qrd_cuda, "_SO",
                        str(tmp_path / "build" / "libtheora_qrd.so"))
    so = qrd_cuda.build()
    assert len(calls) == 1
    cmd = calls[0]
    assert cmd[0] == "nvcc"
    assert cmd[cmd.index("-gencode") + 1] == "arch=compute_90a,code=sm_90a"
    assert "-fmad=false" in cmd
    assert not any("fast_math" in c or "fast-math" in c for c in cmd)
    assert cmd[-1] == qrd_cuda._SRC
    assert cmd[-1].endswith(os.path.join("csrc", "quantize_rd.cu"))
    assert so == qrd_cuda._SO and os.path.exists(so)


def test_kr_wrapper_output_on_cpu():
    """Shapes and types at K = 1 and 3, and an all-zero input's result:
    zero values and counts, every block DC-only; nothing counts as a
    launch."""
    from theora_tpu_torch.ops import qrd_cuda

    vals, cnt, dc_only = qrd_cuda.quantize_rd(*_kr_args("cpu"))
    assert vals.dtype == torch.int16 and vals.shape == (1, 5, 64)
    assert cnt.dtype == torch.int32 and cnt.shape == (1, 5)
    assert dc_only.dtype == torch.bool and dc_only.shape == (1, 5)
    assert not vals.any() and not cnt.any() and dc_only.all()
    args = list(_kr_args("cpu"))
    args[0] = torch.zeros((3, 5, 64), dtype=torch.int16)
    args[2] = torch.full((3, 2, 64), 8, dtype=torch.int16)
    args[4] = torch.ones((3, 2))
    vals, cnt, dc_only = qrd_cuda.quantize_rd(*args)
    assert vals.shape == (3, 5, 64) and cnt.shape == dc_only.shape == (3, 5)
    assert qrd_cuda.quantize_rd.launches == 0


# ------------------------------------------------- the mesh GOP encoder

def test_mesh_encoder_takes_the_jax_signatures():
    """encode_clip_mesh, MeshGopEncoder (constructor and encode_gops),
    make_mesh and rate_psum take JAX's parameters with JAX's defaults;
    the mesh runs on the card unless asked for the CPU."""
    import inspect

    from theora_tpu.parallel import gop as jgop
    from theora_tpu_torch.parallel import gop as pgop

    def params(fn):
        return {k: v.default
                for k, v in inspect.signature(fn).parameters.items()}

    for fn in ("encode_clip_mesh", "make_mesh", "rate_psum"):
        assert params(getattr(pgop, fn)) == params(getattr(jgop, fn)), fn
    for fn in ("__init__", "encode_gops"):
        assert params(getattr(pgop.MeshGopEncoder, fn)) == \
            params(getattr(jgop.MeshGopEncoder, fn)), fn
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pgop.make_mesh(2)


@pytest.mark.parametrize("kernel,which,bad", [
    ("K2", 1, torch.full((2, 1, 2, 64), 8, dtype=torch.int16)),
    ("K2", 1, torch.full((65, 1, 2, 64), 8, dtype=torch.int16)),
    ("KT", 4, torch.full((1, 1), 100.0)),
    ("KT", 4, torch.full((5, 2), 100.0)),
    ("KT", 4, torch.full((1,), 100.0)),
    ("KR", 4, torch.ones((1, 2))),
    ("KR", 4, torch.ones((5, 1, 3))),
    ("KR", 4, torch.ones((1, 1, 2))),
])
def test_segment_forms_the_wrappers_reject(kernel, which, bad):
    """Dequant rows [G, K, 2, 64] split the N blocks into G segments of N
    / G: a G that does not divide N, or lambdas without the segment axis
    or of another segment count raise."""
    from theora_tpu_torch.ops import fdct_cuda, qrd_cuda, trellis_cuda

    seg = torch.full((5, 1, 2, 64), 8, dtype=torch.int16)
    if kernel == "K2":
        args, fn = [*_k2_args("cpu")], fdct_cuda.fdct_quantize
        args[1] = seg
    elif kernel == "KT":
        args, fn = [*_kt_args("cpu")], trellis_cuda.trellis_quantize
        args[2], args[4] = seg, torch.full((5, 1), 100.0)
    else:
        args, fn = [*_kr_args("cpu")], qrd_cuda.quantize_rd
        args[2], args[4] = seg, torch.ones((5, 1, 2))
    fn(*args)  # the segment form itself is taken
    args[which] = bad
    with pytest.raises((TypeError, ValueError)):
        fn(*args)
