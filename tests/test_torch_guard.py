"""Guards of the PyTorch port: it imports neither JAX nor the JAX
package (nor do the testdata scripts chip_smoke.py runs, at import), it
never falls back to the CPU when a card is missing, the
kernel wrappers (K1 at both entries, K2, KT, KR, KM, KL, KS and KS's
fused entries in K2, KR and K1) take their plain paths only for CPU
tensors and K1's have no fallback, K1, KT and KR are built
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

# The tests run in several worker processes on a few CPUs: one torch
# thread each (their tensors are small, and idle intra-op threads spin).
torch.set_num_threads(1)

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
    for rel in ("encode/intra.py", "encode/encoder.py", "pipeline.py",
                "debug.py"):
        assert os.path.join(REPO_ROOT, "theora_tpu_torch", rel) in sources
    bad = []
    for path in sources:
        for mod in _imported_modules(path):
            if mod.split(".")[0] in FORBIDDEN:
                bad.append((os.path.relpath(path, REPO_ROOT), mod))
    assert not bad, bad


def test_smoke_scripts_import_no_jax_when_loaded():
    scripts = _smoke_scripts()
    names = sorted(os.path.basename(p) for p in scripts)
    assert names == ["make_compat_enc.py", "make_hd720.py",
                     "make_hd720_enc.py"]
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


def test_batch_intra_encoder_without_card_raises(monkeypatch):
    from theora_tpu_torch.encode.intra import BatchIntraEncoder

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchIntraEncoder(_small_info())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchIntraEncoder(_small_info(), device="cuda")
    assert BatchIntraEncoder(_small_info(),
                             device="cpu").device.type == "cpu"


def test_pipeline_cores_take_plain_paths_only_for_cpu_tensors(monkeypatch):
    """The cores reach K2's and K1's plain versions through the kernel
    wrappers, which take them only for CPU tensors: a tensor on any other
    device never gets there."""
    from theora_tpu_torch import pipeline
    from theora_tpu_torch.ops import fdct_cuda

    calls = []

    def plain(res, deq, inter):
        calls.append(res.device.type)
        raise AssertionError("plain version reached")

    monkeypatch.setattr(transforms, "fdct_quantize", plain)
    blocks = torch.zeros((2, 8, 8), dtype=torch.uint8, device="meta")
    dq = torch.ones(64, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        pipeline.intra_encode_core(blocks, dq)
    with pytest.raises(ValueError, match="unsupported device"):
        pipeline.inter_encode_core(blocks, blocks, torch.zeros(
            2, dtype=torch.bool, device="meta"), dq, dq)
    assert calls == []
    with pytest.raises(AssertionError, match="plain version reached"):
        fdct_cuda.fdct_quantize(torch.zeros((2, 64), dtype=torch.int16),
                                torch.ones((1, 2, 64), dtype=torch.int16),
                                torch.zeros(2, dtype=torch.uint8))
    assert calls == ["cpu"]


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


def _fused_args(device):
    n = 5
    return (
        torch.zeros((n, 64), dtype=torch.int16, device=device),
        torch.full((1, 2, 64), 8, dtype=torch.int16, device=device),
        torch.zeros(n, dtype=torch.uint8, device=device),
        torch.tensor([[10.0, 12.0]], device=device),
    )


def test_kr_fused_plain_path_only_for_cpu_tensors(monkeypatch):
    """KR's fused entry runs its plain version (transforms.
    fdct_quantize_rd) for CPU tensors only; for any other device it
    raises before calling it, and nothing counts as a launch."""
    from theora_tpu_torch.ops import qrd_cuda

    calls = []

    def plain(*args):
        calls.append(args[0].device.type)
        n = args[0].shape[0]
        return (torch.zeros((1, n, 64), dtype=torch.int16),
                torch.zeros((1, n), dtype=torch.int32),
                torch.ones((1, n), dtype=torch.bool))

    monkeypatch.setattr(transforms, "fdct_quantize_rd", plain)
    qrd_cuda.fdct_quantize_rd(*_fused_args("cpu"))
    assert calls == ["cpu"]
    with pytest.raises(ValueError, match="unsupported device"):
        qrd_cuda.fdct_quantize_rd(*_fused_args("meta"))
    assert calls == ["cpu"]
    assert qrd_cuda.fdct_quantize_rd.launches == 0


@pytest.mark.parametrize("which,bad", [
    (0, torch.zeros((5, 63), dtype=torch.int16)),
    (0, torch.zeros((5, 64), dtype=torch.int32)),
    (0, torch.zeros((64, 5), dtype=torch.int16).T),
    (0, torch.zeros(5 * 64 + 1, dtype=torch.int16)[1:].view(5, 64)),
    (0, torch.zeros((5, 64), dtype=torch.int16, device="meta")),
    (1, torch.full((2, 64), 8, dtype=torch.int16)),
    (1, torch.full((4, 2, 64), 8, dtype=torch.int16)),
    (1, torch.full((1, 2, 64), 8, dtype=torch.int32)),
    (1, torch.full((2, 1, 2, 64), 8, dtype=torch.int16)),
    (2, torch.zeros(5, dtype=torch.bool)),
    (2, torch.zeros(6, dtype=torch.uint8)),
    (3, np.array([[10.0, 12.0]], np.float32)),
    (3, torch.tensor([10.0, 12.0])),
    (3, torch.tensor([[10.0, 12.0]], dtype=torch.float64)),
    (3, torch.tensor([[10.0, 12.0], [1.0, 2.0]])),
    (3, torch.tensor([[[10.0, 12.0]]])),
    (3, torch.tensor([[10.0, 12.0]], device="meta")),
    (3, torch.tensor([[10.0, 0.0], [12.0, 0.0]]).T[:1]),
])
def test_kr_fused_wrapper_rejects_what_the_kernel_does_not_take(which, bad):
    from theora_tpu_torch.ops import qrd_cuda

    args = list(_fused_args("cpu"))
    args[which] = bad
    with pytest.raises((TypeError, ValueError)):
        qrd_cuda.fdct_quantize_rd(*args)


def test_kr_fused_wrapper_output_on_cpu():
    """Shapes and types at K = 1 and 3 and over 5 one-block segments, each
    equal to K2's wrapper followed by KR's standalone wrapper on the same
    CPU tensors; nothing counts as a launch."""
    from theora_tpu_torch.ops import fdct_cuda, qrd_cuda

    rng = np.random.default_rng(5)
    args = list(_fused_args("cpu"))
    args[0] = torch.from_numpy(rng.integers(-60, 60, (5, 64)).astype(
        np.int16))
    args[2] = torch.tensor([0, 1, 1, 0, 1], dtype=torch.uint8)
    for deq, lam in ((args[1], args[3]),
                     (torch.full((3, 2, 64), 8, dtype=torch.int16),
                      torch.ones((3, 2))),
                     (torch.full((5, 2, 2, 64), 6, dtype=torch.int16),
                      torch.full((5, 2, 2), 40.0))):
        k = deq.shape[-3]
        got = qrd_cuda.fdct_quantize_rd(args[0], deq, args[2], lam)
        assert got[0].dtype == torch.int16 and got[0].shape == (k, 5, 64)
        assert got[1].dtype == torch.int32 and got[1].shape == (k, 5)
        assert got[2].dtype == torch.bool and got[2].shape == (k, 5)
        q, d = fdct_cuda.fdct_quantize(args[0], deq, args[2])
        want = qrd_cuda.quantize_rd(q, d, deq, args[2], lam)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert qrd_cuda.fdct_quantize_rd.launches == 0
    assert fdct_cuda.fdct_quantize.launches == 0


@pytest.mark.parametrize("wrapper,lib", [
    ("fdct_cuda", "libtheora_fdct_quant.so"),
    ("qrd_cuda", "libtheora_qrd.so"),
])
def test_k2_and_kr_rebuild_when_the_block_core_changes(monkeypatch,
                                                       tmp_path, wrapper,
                                                       lib):
    """K2's and KR's libraries depend on csrc/fdct_core.cuh as well as on
    their own sources: nvcc_build rebuilds a library that is older than
    the header, and only then. Nothing is compiled: subprocess.run is
    replaced, and a copy of the header stands for it."""
    import importlib
    import subprocess
    import time

    from theora_tpu_torch.ops import cuda_build

    mod = importlib.import_module(f"theora_tpu_torch.ops.{wrapper}")
    calls = []

    def run(cmd, **kwargs):
        calls.append(cmd)
        return subprocess.CompletedProcess(cmd, 0, "", "ptxas info")

    core = tmp_path / "fdct_core.cuh"
    core.write_text("// header\n")
    old = time.time() - 3600
    os.utime(core, (old, old))
    monkeypatch.setattr(cuda_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(subprocess, "run", run)
    monkeypatch.setattr(mod, "_SO", str(tmp_path / "build" / lib))
    monkeypatch.setattr(mod, "CORE", str(core))
    assert mod.build() == mod._SO and len(calls) == 1
    assert mod.build() == mod._SO and len(calls) == 1   # up to date
    # The library built half an hour ago, the header edited since.
    os.utime(mod._SO, (old + 1800, old + 1800))
    os.utime(core, (old + 3000, old + 3000))
    assert mod.build() == mod._SO and len(calls) == 2
    assert calls[1][-1] == mod._SRC
    assert mod.build() == mod._SO and len(calls) == 2


def test_nvcc_build_checks_every_dependency(monkeypatch, tmp_path):
    """nvcc_build compiles when the library is missing, or older than the
    source or any of deps, and not otherwise."""
    import subprocess

    from theora_tpu_torch.ops import cuda_build

    calls = []

    def run(cmd, **kwargs):
        calls.append(cmd)
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(cuda_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(subprocess, "run", run)
    src, a, b = (tmp_path / n for n in ("k.cu", "a.cuh", "b.cuh"))
    for f in (src, a, b):
        f.write_text("")
        os.utime(f, (1000, 1000))
    so = str(tmp_path / "build" / "libk.so")
    cuda_build.nvcc_build(str(src), so, deps=(str(a), str(b)))
    os.utime(so, (2000, 2000))
    cuda_build.nvcc_build(str(src), so, deps=(str(a), str(b)))
    assert len(calls) == 1
    for f, t in ((b, 3000), (src, 4000)):
        os.utime(f, (t, t))
        cuda_build.nvcc_build(str(src), so, deps=(str(a), str(b)))
        os.utime(so, (t + 1, t + 1))
    assert len(calls) == 3
    os.utime(a, (9000, 9000))
    cuda_build.nvcc_build(str(src), so)   # a is not among its deps
    assert len(calls) == 3


# ------------------------------------------------------------- kernel KM

def _km_args(device):
    ys = torch.zeros((3, 32, 48), dtype=torch.uint8, device=device)
    return ys, torch.zeros(2, dtype=torch.int64, device=device)


def test_km_plain_path_only_for_cpu_tensors(monkeypatch):
    from theora_tpu_torch.ops import me, me_cuda

    calls = []

    def plain(ys, gold_idx):
        calls.append(ys.device.type)
        return ()

    monkeypatch.setattr(me, "plan_with_gold", plain)
    me_cuda.plan_with_gold(*_km_args("cpu"))
    assert calls == ["cpu"]
    with pytest.raises(ValueError, match="unsupported device"):
        me_cuda.plan_with_gold(*_km_args("meta"))
    assert calls == ["cpu"]
    assert me_cuda.plan_with_gold.launches == 0
    tree = _parse(me_cuda.__file__)
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)]


@pytest.mark.parametrize("which,bad", [
    (0, torch.zeros((3, 32, 48), dtype=torch.int16)),
    (0, torch.zeros((3, 32, 48), dtype=torch.int32)),
    (0, torch.zeros((1, 32, 48), dtype=torch.uint8)),
    (0, torch.zeros((3, 40, 48), dtype=torch.uint8)),
    (0, torch.zeros((3, 32, 50), dtype=torch.uint8)),
    (0, torch.zeros((3, 8, 48), dtype=torch.uint8)),
    (0, torch.zeros((32, 48), dtype=torch.uint8)),
    (0, torch.zeros((3, 48, 32), dtype=torch.uint8).transpose(1, 2)),
    (0, torch.zeros((3, 32, 64), dtype=torch.uint8)[:, :, :48]),
    (0, np.zeros((3, 32, 48), np.uint8)),
    (1, torch.zeros(2, dtype=torch.int32)),
    (1, torch.zeros(3, dtype=torch.int64)),
    (1, torch.zeros((2, 1), dtype=torch.int64)),
    (1, torch.zeros(4, dtype=torch.int64)[::2]),
    (1, torch.zeros(2, dtype=torch.int64, device="meta")),
    (1, np.zeros(2, np.int64)),
])
def test_km_wrapper_rejects_what_the_kernel_does_not_take(which, bad):
    from theora_tpu_torch.ops import me_cuda

    args = list(_km_args("cpu"))
    args[which] = bad
    with pytest.raises((TypeError, ValueError)):
        me_cuda.plan_with_gold(*args)


def test_km_build_is_sm90a(monkeypatch, tmp_path):
    """KM's library is built by nvcc_build from csrc/me.cu for sm_90a,
    without fast math (its arithmetic is integer). Nothing is compiled:
    subprocess.run is replaced."""
    import subprocess

    from theora_tpu_torch.ops import cuda_build, me_cuda

    calls = []

    def run(cmd, **kwargs):
        calls.append(cmd)
        return subprocess.CompletedProcess(cmd, 0, "", "ptxas info")

    monkeypatch.setattr(cuda_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(subprocess, "run", run)
    monkeypatch.setattr(me_cuda, "_SO",
                        str(tmp_path / "build" / "libtheora_me.so"))
    so = me_cuda.build()
    assert len(calls) == 1
    cmd = calls[0]
    assert cmd[0] == "nvcc"
    assert cmd[cmd.index("-gencode") + 1] == "arch=compute_90a,code=sm_90a"
    assert not any("fast_math" in c or "fast-math" in c for c in cmd)
    assert cmd[-1] == me_cuda._SRC
    assert cmd[-1].endswith(os.path.join("csrc", "me.cu"))
    assert so == me_cuda._SO and os.path.exists(so)
    with open(so + ".log") as f:
        assert f.read() == "ptxas info"


def test_simd_rate_build_is_sm90a(monkeypatch, tmp_path):
    """The byte-SIMD rate measurement of tools/bench_me.py is built by
    nvcc_build from csrc/simd_rate.cu for sm_90a beside KM's library.
    Nothing is compiled: subprocess.run is replaced."""
    import subprocess

    from theora_tpu_torch.ops import cuda_build, me_cuda
    from theora_tpu_torch.tools import bench_me

    calls = []

    def run(cmd, **kwargs):
        calls.append(cmd)
        return subprocess.CompletedProcess(cmd, 0, "", "ptxas info")

    monkeypatch.setattr(cuda_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(subprocess, "run", run)
    monkeypatch.setattr(me_cuda, "_SO",
                        str(tmp_path / "build" / "libtheora_me.so"))
    so = bench_me.simd_build()
    assert len(calls) == 1
    cmd = calls[0]
    assert cmd[cmd.index("-gencode") + 1] == "arch=compute_90a,code=sm_90a"
    assert cmd[-1].endswith(os.path.join("csrc", "simd_rate.cu"))
    assert so == str(tmp_path / "build" / "libtheora_simd_rate.so")
    assert os.path.exists(so)


def test_km_bound_counts_byte_simd_and_the_measured_rates():
    """bench_me.km_ops, the bound every KM design is held to, is the sum
    of km_op_mix: 677,383,056 instructions for 7 rows of 720p luma,
    2,225,687,184 for 23. km_bound_at takes each kind at its own measured
    rate and a pyramid pair at the best of its three forms."""
    from theora_tpu_torch.tools import bench_me as bm

    for rows, ops in ((7, 677383056), (23, 2225687184)):
        assert bm.km_ops(rows, 720, 1280) == ops == sum(
            bm.km_op_mix(rows, 720, 1280).values())
    ys = np.zeros((8, 720, 1280), np.uint8)
    mix = bm.km_op_mix(7, 720, 1280)
    rates = {k: {"per_s": 1e12, "per_sm_clock": 1.0} for k in bm.SIMD_OPS}
    flat = sum(mix.values()) / 1e12 * 1e3
    assert bm.km_bound_at(ys, rates)["ops_ms"] == pytest.approx(flat)
    rates["vsadu2"]["per_s"] = 1e11  # the min form takes the pairs
    assert bm.km_bound_at(ys, rates)["ops_ms"] == pytest.approx(flat)
    rates["min_u16x2"]["per_s"] = 1e11  # two scalar vabsdiff a pair
    slow = flat + mix["vsadu2"] / 1e12 * 1e3
    assert bm.km_bound_at(ys, rates)["ops_ms"] == pytest.approx(slow)
    assert bm.km_bound_at(ys, rates)["bound_by"] == "operations"


def test_dispatch_me_reaches_km_and_nothing_calls_the_plain_plan(
        monkeypatch):
    """GopEncoder.dispatch_me takes its plan from me_cuda.plan_with_gold
    (the mesh and the transcode reach the ME through it), and no module of
    the port but the wrapper calls ops/me.py's plan functions (the tools
    and chip_smoke.py call them to hold the kernel against them)."""
    from theora_tpu_torch.encode.gop import GopEncoder
    from theora_tpu_torch.ops import me_cuda

    calls = []
    real = me_cuda.plan_with_gold

    def spy(ys, gold_idx):
        calls.append((tuple(ys.shape), gold_idx.tolist()))
        return real(ys, gold_idx)

    monkeypatch.setattr(me_cuda, "plan_with_gold", spy)
    rng = np.random.default_rng(3)
    frames = [[rng.integers(0, 256, (48, 64), dtype=np.uint8),
               rng.integers(0, 256, (24, 32), dtype=np.uint8),
               rng.integers(0, 256, (24, 32), dtype=np.uint8)]
              for _ in range(3)]
    enc = GopEncoder(_small_info(), device="cpu")
    enc.dispatch_me(frames, kf_flags=[True, False, True])
    assert calls == [((3, 48, 64), [0, 2])]

    plain = {"plan", "plan_with_gold", "plan_from_gop"}
    for path in _port_sources():
        rel = os.path.relpath(path, REPO_ROOT)
        if rel in (os.path.join("theora_tpu_torch", "ops", "me_cuda.py"),
                   os.path.join("theora_tpu_torch", "ops", "me.py"),
                   "chip_smoke.py") or \
                rel.startswith(os.path.join("theora_tpu_torch", "tools")):
            continue
        tree = _parse(path)
        me_names = {a.asname or a.name for n in ast.walk(tree)
                    if isinstance(n, ast.ImportFrom) and n.module and
                    n.module.endswith("ops") for a in n.names
                    if a.name == "me"}
        for n in ast.walk(tree):
            if isinstance(n, ast.ImportFrom) and n.module and \
                    n.module.endswith("ops.me"):
                assert not plain & {a.name for a in n.names}, path
            if isinstance(n, ast.Attribute) and n.attr in plain and \
                    isinstance(n.value, ast.Name) and n.value.id in me_names:
                raise AssertionError(f"{path}:{n.lineno} calls me.{n.attr}")


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


# ------------------------------------------------------------- kernel KL

def _kl_args(device, g=0):
    nv, nh, pad = 2, 3, 8
    shape = (8 * nv + 2 * pad, 8 * nh + 2 * pad)
    if g:
        return (torch.zeros((g,) + shape, dtype=torch.uint8, device=device),
                torch.zeros((g, nv, nh), dtype=torch.bool, device=device),
                torch.ones(g, dtype=torch.int32, device=device), nv, nh, pad,
                pad)
    return (torch.zeros(shape, dtype=torch.uint8, device=device),
            torch.zeros((nv, nh), dtype=torch.bool, device=device), 5, nv,
            nh, pad, pad)


@pytest.mark.parametrize("g", [0, 3])
def test_kl_plain_path_only_for_cpu_tensors(monkeypatch, g):
    from theora_tpu_torch.ops import loopfilter, loopfilter_cuda

    calls = []

    def plain(plane, *args):
        calls.append(plane.device.type)
        return plane

    monkeypatch.setattr(loopfilter, "loop_filter_plane", plain)
    loopfilter_cuda.loop_filter_plane(*_kl_args("cpu", g))
    assert calls == ["cpu"]
    with pytest.raises(ValueError, match="unsupported device"):
        loopfilter_cuda.loop_filter_plane(*_kl_args("meta", g))
    assert calls == ["cpu"]
    assert loopfilter_cuda.loop_filter_plane.launches == 0
    tree = _parse(loopfilter_cuda.__file__)
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)]


@pytest.mark.parametrize("g,which,bad", [
    (0, 0, torch.zeros((32, 40), dtype=torch.int16)),
    (0, 0, torch.zeros((40, 32), dtype=torch.uint8).t()),
    (0, 0, torch.zeros((32, 48), dtype=torch.uint8)[:, :40]),
    (0, 0, torch.zeros((25, 40), dtype=torch.uint8)),
    (0, 0, torch.zeros((32, 36), dtype=torch.uint8)),
    (0, 0, torch.zeros((32,), dtype=torch.uint8)),
    (0, 0, np.zeros((32, 40), np.uint8)),
    (0, 1, torch.zeros((2, 3), dtype=torch.uint8)),
    (0, 1, torch.zeros((3, 2), dtype=torch.bool)),
    (0, 1, torch.zeros((2, 6), dtype=torch.bool)[:, ::2]),
    (0, 1, torch.zeros((2, 3), dtype=torch.bool, device="meta")),
    (0, 2, torch.tensor(5, dtype=torch.int32)),
    (0, 3, 4),
    (0, 4, 5),
    (0, 5, 1),
    (0, 6, 4),
    (0, 6, 12),
    # The image must fill the plane but for the padding: Hp = 8 nv +
    # 2 pad_y, Wp = 8 nh + 2 pad_x.
    (0, 0, torch.zeros((34, 40), dtype=torch.uint8)),
    (0, 0, torch.zeros((32, 48), dtype=torch.uint8)),
    (0, 3, 1),
    (0, 4, 2),
    (0, 5, 4),
    (0, 6, 16),
    (3, 0, torch.zeros((3, 32, 48), dtype=torch.uint8)),
    (3, 0, torch.zeros((2, 32, 40), dtype=torch.uint8)),
    (3, 1, torch.zeros((2, 3), dtype=torch.bool)),
    (3, 2, 5),
    (3, 2, torch.ones(3, dtype=torch.int64)),
    (3, 2, torch.ones(2, dtype=torch.int32)),
    (3, 2, torch.ones(6, dtype=torch.int32)[::2]),
])
def test_kl_wrapper_rejects_what_the_kernel_does_not_take(g, which, bad):
    from theora_tpu_torch.ops import loopfilter_cuda

    args = list(_kl_args("cpu", g))
    args[which] = bad
    with pytest.raises((TypeError, ValueError)):
        loopfilter_cuda.loop_filter_plane(*args)


def test_borders_run_only_on_steps_kl_skips(monkeypatch):
    """KL fills the borders of the planes it filters, so the encode scan
    and the decode step ask for the borders (the borders flag of K1's
    fused encode entry, which runs KS's plane assembly, and of KS's
    decode entry) only on frame steps whose limit is 0 (qi 47 and above):
    none at qi 40, one per plane per frame at qi 56, each on [G, Hp, Wp]
    reference planes; and the decode of a q5 clip none."""
    from theora_tpu_torch.decode.batch import BatchDecoder
    from theora_tpu_torch.encode.gop import GopEncoder
    from theora_tpu_torch.headers import parse_info_header, \
        parse_setup_header
    from theora_tpu_torch.ops import mc_cuda
    from theora_tpu_torch.tpkt import read_tpkt

    calls = []

    def spy(real, plane):
        def call(*args, borders, **kwargs):
            if borders:
                calls.append(args[plane].dim())
            return real(*args, borders=borders, **kwargs)
        return call

    monkeypatch.setattr(idct_cuda, "mc_idct_recon_skip",
                        spy(idct_cuda.mc_idct_recon_skip, 5))
    monkeypatch.setattr(mc_cuda, "mc_recon", spy(mc_cuda.mc_recon, 0))
    rng = np.random.default_rng(5)
    frames = [[rng.integers(0, 256, (48, 64), dtype=np.uint8),
               rng.integers(0, 256, (24, 32), dtype=np.uint8),
               rng.integers(0, 256, (24, 32), dtype=np.uint8)]
              for _ in range(3)]
    GopEncoder(_small_info(), qi=40, device="cpu").encode_clip(
        frames, keyframe_freq=8)
    assert calls == []
    GopEncoder(_small_info(), qi=56, device="cpu").encode_clip(
        frames, keyframe_freq=8)
    assert calls == [3] * 9
    calls.clear()
    pkts = read_tpkt(os.path.join(TESTDATA, "clip64x48_k8_q5.tpkt"))
    dec = BatchDecoder(parse_info_header(pkts[0].data),
                       parse_setup_header(pkts[2].data), device="cpu")
    assert dec.decode_clip([p.data for p in pkts[3:]], batch=8)
    assert calls == []


def test_kl_build_is_sm90a(monkeypatch, tmp_path):
    """KL's library is built by nvcc_build from csrc/loopfilter.cu for
    sm_90a, without fast math (its arithmetic is integer). Nothing is
    compiled: subprocess.run is replaced."""
    import subprocess

    from theora_tpu_torch.ops import cuda_build, loopfilter_cuda

    calls = []

    def run(cmd, **kwargs):
        calls.append(cmd)
        return subprocess.CompletedProcess(cmd, 0, "", "ptxas info")

    monkeypatch.setattr(cuda_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(subprocess, "run", run)
    monkeypatch.setattr(loopfilter_cuda, "_SO",
                        str(tmp_path / "build" / "libtheora_loopfilter.so"))
    so = loopfilter_cuda.build()
    assert len(calls) == 1
    cmd = calls[0]
    assert cmd[0] == "nvcc"
    assert cmd[cmd.index("-gencode") + 1] == "arch=compute_90a,code=sm_90a"
    assert not any("fast_math" in c or "fast-math" in c for c in cmd)
    assert cmd[-1] == loopfilter_cuda._SRC
    assert cmd[-1].endswith(os.path.join("csrc", "loopfilter.cu"))
    assert so == loopfilter_cuda._SO and os.path.exists(so)


def test_scan_and_decode_reach_kl_and_nothing_calls_the_plain_filter(
        monkeypatch):
    """The encode scan filters through loopfilter_cuda.loop_filter_plane
    with [G, Hp, Wp] planes and a [G] limit tensor, once per plane per
    frame step whose limit is above 0; the decode step with one plane and
    an int limit. No module of the port but the wrapper calls
    ops/loopfilter.py's filter (the tools and chip_smoke.py call it to
    hold the kernel against it)."""
    from theora_tpu_torch.decode.batch import BatchDecoder
    from theora_tpu_torch.encode.gop import GopEncoder
    from theora_tpu_torch.headers import parse_info_header, \
        parse_setup_header
    from theora_tpu_torch.ops import loopfilter_cuda
    from theora_tpu_torch.tpkt import read_tpkt

    calls = []
    real = loopfilter_cuda.loop_filter_plane

    def spy(plane, coded, limit, *rest):
        calls.append((plane.dim(), isinstance(limit, torch.Tensor)))
        return real(plane, coded, limit, *rest)

    monkeypatch.setattr(loopfilter_cuda, "loop_filter_plane", spy)
    rng = np.random.default_rng(5)
    frames = [[rng.integers(0, 256, (48, 64), dtype=np.uint8),
               rng.integers(0, 256, (24, 32), dtype=np.uint8),
               rng.integers(0, 256, (24, 32), dtype=np.uint8)]
              for _ in range(3)]
    enc = GopEncoder(_small_info(), qi=40, device="cpu")
    enc.encode_clip(frames, keyframe_freq=8)
    assert calls == [(3, True)] * 9
    calls.clear()
    pkts = read_tpkt(os.path.join(TESTDATA, "clip64x48_k8_q5.tpkt"))
    dec = BatchDecoder(parse_info_header(pkts[0].data),
                       parse_setup_header(pkts[2].data), device="cpu")
    n = len(dec.decode_clip([p.data for p in pkts[3:]], batch=8))
    assert calls == [(2, False)] * (3 * n)

    for path in _port_sources():
        rel = os.path.relpath(path, REPO_ROOT)
        if rel in (os.path.join("theora_tpu_torch", "ops",
                                "loopfilter_cuda.py"),
                   "chip_smoke.py") or \
                rel.startswith(os.path.join("theora_tpu_torch", "tools")):
            continue
        for n in ast.walk(_parse(path)):
            if isinstance(n, ast.ImportFrom) and n.module:
                names = {a.name for a in n.names}
                assert not (n.module.endswith("ops.loopfilter")
                            and "loop_filter_plane" in names), rel
                assert not (n.module.endswith("ops")
                            and "loopfilter" in names), rel


# ------------------------------------------------------------- kernel KS

def _ks_args(entry, device, fid=False):
    """Small valid arguments of a KS entry (2 x 3 fragments padded by 16
    and 8, G = 2 planes on the encode side)."""
    nv, nh, py, px = 2, 3, 16, 8
    n, G = nv * nh, 2
    hp, wp = 8 * nv + 2 * py, 8 * nh + 2 * px
    geom = (nv, nh, py, px)

    def z(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    if entry == "mc_recon":
        return (z((hp, wp), torch.uint8), z((hp, wp), torch.uint8),
                z((n, 64), torch.int16), z((6, n), torch.int8), *geom, True,
                z((8 * nv, 8 * nh), torch.uint8))
    if entry == "place_rows":
        return (z((G * n, 65), torch.uint8), G, *geom, True)
    nl = 4 if fid else n
    N = G * nl
    ids = (torch.arange(nl, dtype=torch.int32, device=device),) if fid \
        else ()
    if entry == "mc_residual":
        return (z((G, hp, wp), torch.uint8), z((G, hp, wp), torch.uint8),
                z((N, 64), torch.uint8), z((6, N), torch.int8), *geom, *ids)
    head = (z((G, hp, wp), torch.uint8), z((N, 64), torch.uint8),
            z((N, 64), torch.int16), z((N,), torch.int32),
            z((N,), torch.int32), z((N,), torch.int32), z((N,), torch.bool),
            z((G,), torch.float32), False, z((N, 64), torch.int16),
            z((N,), torch.bool), *geom)
    return head + (ids if entry == "skip_rows" else (True,))


KS_ENTRIES = ("mc_residual", "skip_place", "skip_rows", "place_rows",
              "mc_recon")


@pytest.mark.parametrize("entry", KS_ENTRIES)
def test_ks_plain_path_only_for_cpu_tensors(monkeypatch, entry):
    """Each KS wrapper runs its plain version (ops/mc.py, the entry of the
    same name) for CPU tensors only, raises for another device, counts no
    launch on the CPU, and has no try that could fall back."""
    from theora_tpu_torch.ops import mc, mc_cuda

    calls = []
    real = getattr(mc, entry)

    def plain(*args, **kwargs):
        calls.append(args[0].device.type)
        return real(*args, **kwargs)

    monkeypatch.setattr(mc, entry, plain)
    wrapper = getattr(mc_cuda, entry)
    wrapper(*_ks_args(entry, "cpu", fid=entry == "skip_rows"))
    assert calls == ["cpu"]
    with pytest.raises(ValueError, match="unsupported device"):
        wrapper(*_ks_args(entry, "meta", fid=entry == "skip_rows"))
    assert calls == ["cpu"]
    assert wrapper.launches == 0
    tree = _parse(mc_cuda.__file__)
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)]


@pytest.mark.parametrize("entry,which,bad", [
    # The planes: type, dtype, layout, geometry, device.
    ("mc_residual", 0, np.zeros((2, 48, 40), np.uint8)),
    ("mc_residual", 0, torch.zeros((2, 48, 40), dtype=torch.int16)),
    ("mc_residual", 0, torch.zeros((48, 40), dtype=torch.uint8)),
    ("mc_residual", 0, torch.zeros((2, 40, 48), dtype=torch.uint8)
     .transpose(1, 2)),
    ("mc_residual", 0, torch.zeros((2, 50, 40), dtype=torch.uint8)),
    ("mc_residual", 1, torch.zeros((2, 48, 48), dtype=torch.uint8)),
    ("mc_residual", 1, torch.zeros((2, 48, 40), dtype=torch.uint8,
                                   device="meta")),
    ("mc_residual", 2, torch.zeros((12, 64), dtype=torch.int16)),
    ("mc_residual", 2, torch.zeros((11, 64), dtype=torch.uint8)),
    ("mc_residual", 3, torch.zeros((6, 12), dtype=torch.int64)),
    ("mc_residual", 3, torch.zeros((12, 6), dtype=torch.int8).t()),
    ("mc_residual", 7, 4),   # pad_x not a multiple of 8
    ("mc_residual", 6, 1),   # pad_y below 2
    ("mc_residual", 4, 3),   # nv does not match the plane
    ("mc_residual", 8, torch.arange(4)),   # fid int64
    ("mc_residual", 8, torch.arange(7, dtype=torch.int32)),  # > n ids
    ("skip_place", 1, torch.zeros((12, 64), dtype=torch.int16)),
    ("skip_place", 2, torch.zeros((12, 64), dtype=torch.uint8)),
    ("skip_place", 3, torch.zeros((12,), dtype=torch.int64)),
    ("skip_place", 5, torch.zeros((11,), dtype=torch.int32)),
    ("skip_place", 6, torch.zeros((12,), dtype=torch.uint8)),
    ("skip_place", 7, torch.zeros((3,), dtype=torch.float32)),
    ("skip_place", 7, torch.zeros((2,), dtype=torch.float64)),
    ("skip_place", 9, torch.zeros((12, 128), dtype=torch.int16)[:, ::2]),
    ("skip_place", 10, torch.zeros((12,), dtype=torch.uint8)),
    ("skip_rows", 15, torch.zeros((5,), dtype=torch.int32)),
    ("place_rows", 0, torch.zeros((12, 64), dtype=torch.uint8)),
    ("place_rows", 0, torch.zeros((12, 66), dtype=torch.uint8)[:, :65]),
    ("place_rows", 1, 3),
    ("place_rows", 5, 12),
    ("mc_recon", 0, torch.zeros((2, 48, 40), dtype=torch.uint8)),
    ("mc_recon", 1, torch.zeros((48, 48), dtype=torch.uint8)),
    ("mc_recon", 2, torch.zeros((6, 64), dtype=torch.int32)),
    ("mc_recon", 2, torch.zeros((5, 64), dtype=torch.int16)),
    ("mc_recon", 3, torch.zeros((10, 6), dtype=torch.int8)),
    ("mc_recon", 9, torch.zeros((16, 16), dtype=torch.uint8)),
    ("mc_recon", 9, torch.zeros((16, 24), dtype=torch.int16)),
])
def test_ks_wrappers_reject_what_the_kernel_does_not_take(entry, which,
                                                          bad):
    from theora_tpu_torch.ops import mc_cuda

    fn = getattr(mc_cuda, entry)
    args = list(_ks_args(entry, "cpu", fid=entry == "skip_rows"))
    fn(*args)  # the valid arguments are taken
    if which == len(args):
        args.append(bad)
    else:
        args[which] = bad
    with pytest.raises((TypeError, ValueError)):
        fn(*args)


def test_ks_build_is_sm90a(monkeypatch, tmp_path):
    """KS's library is built by nvcc_build from csrc/mc.cu for sm_90a,
    without fast math (its one float product rounds by the intrinsics
    __fmul_rn and __float2int_rz). Nothing is compiled: subprocess.run is
    replaced."""
    import subprocess

    from theora_tpu_torch.ops import cuda_build, mc_cuda

    calls = []

    def run(cmd, **kwargs):
        calls.append(cmd)
        return subprocess.CompletedProcess(cmd, 0, "", "ptxas info")

    monkeypatch.setattr(cuda_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(subprocess, "run", run)
    monkeypatch.setattr(mc_cuda, "_SO",
                        str(tmp_path / "build" / "libtheora_mc.so"))
    so = mc_cuda.build()
    assert len(calls) == 1
    cmd = calls[0]
    assert cmd[0] == "nvcc"
    assert cmd[cmd.index("-gencode") + 1] == "arch=compute_90a,code=sm_90a"
    assert not any("fast_math" in c or "fast-math" in c for c in cmd)
    assert cmd[-1] == mc_cuda._SRC
    assert cmd[-1].endswith(os.path.join("csrc", "mc.cu"))
    assert so == mc_cuda._SO and os.path.exists(so)
    with open(mc_cuda._SRC) as f:
        src = f.read()
    assert "__fmul_rn(" in src and "__float2int_rz(" in src


def test_scan_and_decode_reach_ks_and_nothing_calls_the_plain_chain(
        monkeypatch):
    """A 3-frame 64x48 encode_clip runs KS inside the scan's fused
    entries: K2's (mc_fdct_quantize) and K1's (mc_idct_recon_skip) once
    per plane per frame step (9 each, K2's before K1's) with [G, Hp, Wp]
    planes, and none of KS's own encode entries (mc_residual, skip_place,
    skip_rows, place_rows: the step has no frag group); the decode of
    clip64x48_k8_q5 calls mc_recon once per plane per frame with [Hp,
    Wp] planes. No module of the port but KS's wrapper and the fused
    wrappers (whose CPU paths compose the plain versions) imports
    ops/mc.py's plain entries or its gathers, blocks_to_plane or
    fill_borders for a step (the tools and chip_smoke.py import the plain
    entries to hold the kernels against them)."""
    from theora_tpu_torch.decode.batch import BatchDecoder
    from theora_tpu_torch.encode.gop import GopEncoder
    from theora_tpu_torch.headers import parse_info_header, \
        parse_setup_header
    from theora_tpu_torch.ops import fdct_cuda, mc_cuda
    from theora_tpu_torch.tpkt import read_tpkt

    calls = []

    def spy(mod, entry, plane):
        real = getattr(mod, entry)

        def call(*args, **kwargs):
            calls.append((entry, args[plane].dim()))
            return real(*args, **kwargs)
        monkeypatch.setattr(mod, entry, call)

    for entry in KS_ENTRIES:
        spy(mc_cuda, entry, 0)
    spy(fdct_cuda, "mc_fdct_quantize", 0)
    spy(idct_cuda, "mc_idct_recon_skip", 5)
    rng = np.random.default_rng(5)
    frames = [[rng.integers(0, 256, (48, 64), dtype=np.uint8),
               rng.integers(0, 256, (24, 32), dtype=np.uint8),
               rng.integers(0, 256, (24, 32), dtype=np.uint8)]
              for _ in range(3)]
    GopEncoder(_small_info(), qi=40, device="cpu").encode_clip(
        frames, keyframe_freq=8)
    assert sorted(calls) == [("mc_fdct_quantize", 3)] * 9 + [
        ("mc_idct_recon_skip", 3)] * 9
    assert calls[:2] == [("mc_fdct_quantize", 3), ("mc_idct_recon_skip", 3)]
    calls.clear()
    pkts = read_tpkt(os.path.join(TESTDATA, "clip64x48_k8_q5.tpkt"))
    dec = BatchDecoder(parse_info_header(pkts[0].data),
                       parse_setup_header(pkts[2].data), device="cpu")
    n = len(dec.decode_clip([p.data for p in pkts[3:]], batch=8))
    assert calls == [("mc_recon", 2)] * (3 * n)

    plain = {"mc_residual", "skip_place", "skip_rows", "place_rows",
             "mc_recon", "mc_predict", "blocks_to_plane", "fill_borders",
             "block_index_grid"}
    ops = os.path.join("theora_tpu_torch", "ops")
    for path in _port_sources():
        rel = os.path.relpath(path, REPO_ROOT)
        if rel in (*(os.path.join(ops, f) for f in (
                "mc_cuda.py", "mc.py", "loopfilter_cuda.py",
                "loopfilter.py")),
                   os.path.join("theora_tpu_torch", "pipeline.py"),
                   "chip_smoke.py") or \
                rel.startswith(os.path.join("theora_tpu_torch", "tools")):
            continue
        fused = rel in (os.path.join(ops, f) for f in (
            "fdct_cuda.py", "qrd_cuda.py", "idct_cuda.py"))
        for node in ast.walk(_parse(path)):
            if isinstance(node, ast.ImportFrom) and node.module:
                names = {a.name for a in node.names}
                assert not (node.module.endswith((".mc", ".loopfilter",
                                                  ".pipeline"))
                            and names & plain), rel
                assert not (node.module.endswith("ops") and "mc" in names
                            and not fused), rel


# ------------------------------------------------- KS fused into K2, KR, K1

KS_FUSED = ("mc_fdct_quantize", "mc_fdct_quantize_rd", "mc_idct_recon_skip")


def _ks_fused(entry):
    from theora_tpu_torch.ops import fdct_cuda, qrd_cuda

    return {"mc_fdct_quantize": fdct_cuda.mc_fdct_quantize,
            "mc_fdct_quantize_rd": qrd_cuda.mc_fdct_quantize_rd,
            "mc_idct_recon_skip": idct_cuda.mc_idct_recon_skip}[entry]


def _ks_fused_args(entry, device, fid=False, k=2):
    """Small valid arguments of a fused entry (mc_residual's planes of
    _ks_args, G = 2 segments of k qi rows)."""
    prev, gold, cur, side, *geom = _ks_args("mc_residual", device, fid)[:8]
    ids = _ks_args("mc_residual", device, fid)[8:]
    N, G = cur.shape[0], prev.shape[0]

    def z(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    deq = torch.full((G, k, 2, 64), 8, dtype=torch.int16, device=device)
    inter = z((N,), torch.uint8)
    if entry == "mc_fdct_quantize":
        return (prev, gold, cur, side, deq, inter, *geom, *ids)
    if entry == "mc_fdct_quantize_rd":
        return (prev, gold, cur, side, deq, inter, z((G, k, 2), torch.float32),
                *geom, *ids)
    return (z((k, N, 64), torch.int16), torch.ones((k, N), dtype=torch.bool,
                                                   device=device),
            z((k, N), torch.int32), deq, inter, prev, gold, cur, side,
            z((N,), torch.bool), torch.ones(G, device=device), None, False,
            z((N, 64), torch.int16), z((N,), torch.bool), z((N,), torch.uint8),
            *geom, True, *ids)


@pytest.mark.parametrize("entry", KS_FUSED)
def test_ks_fused_plain_path_only_for_cpu_tensors(monkeypatch, entry):
    """Each fused wrapper runs its plain chain (ops/mc.py's mc_residual
    first) for CPU tensors only, raises for another device before any
    plain step, counts no launch on the CPU, and its module has no try
    that could fall back."""
    from theora_tpu_torch.ops import mc

    calls = []
    real = mc.mc_residual

    def plain(*args, **kwargs):
        calls.append(args[0].device.type)
        return real(*args, **kwargs)

    monkeypatch.setattr(mc, "mc_residual", plain)
    wrapper = _ks_fused(entry)
    out = wrapper(*_ks_fused_args(entry, "cpu"))
    assert calls == ["cpu"] and out is not None
    with pytest.raises(ValueError, match="unsupported device"):
        wrapper(*_ks_fused_args(entry, "meta"))
    assert calls == ["cpu"]
    assert wrapper.launches == 0
    tree = _parse(__import__(wrapper.__module__, fromlist=["_"]).__file__)
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)]


def _misaligned(t):
    """A tensor like t whose data start one element past an aligned
    allocation."""
    raw = torch.zeros(t.numel() + 8, dtype=t.dtype)[1:t.numel() + 1]
    return raw.view(t.shape)


@pytest.mark.parametrize("entry,which,bad", [
    # The planes: geometry, dtype, layout, segments.
    ("mc_fdct_quantize", 0, torch.zeros((2, 48, 40), dtype=torch.int16)),
    ("mc_fdct_quantize", 0, torch.zeros((2, 50, 40), dtype=torch.uint8)),
    ("mc_fdct_quantize", 1, torch.zeros((2, 48, 48), dtype=torch.uint8)),
    ("mc_fdct_quantize", 2, torch.zeros((12, 64), dtype=torch.int16)),
    ("mc_fdct_quantize", 2, _misaligned(torch.zeros((12, 64),
                                                    dtype=torch.uint8))),
    ("mc_fdct_quantize", 3, torch.zeros((6, 12), dtype=torch.int64)),
    ("mc_fdct_quantize", 4, torch.full((3, 2, 2, 64), 8, dtype=torch.int16)),
    ("mc_fdct_quantize", 5, torch.zeros((11,), dtype=torch.uint8)),
    ("mc_fdct_quantize", 9, 4),    # pad_x not a multiple of 8
    ("mc_fdct_quantize_rd", 0, _misaligned(torch.zeros((2, 48, 40),
                                                       dtype=torch.uint8))),
    ("mc_fdct_quantize_rd", 6, torch.zeros((2, 2, 2), dtype=torch.float64)),
    ("mc_fdct_quantize_rd", 6, torch.zeros((2, 3, 2), dtype=torch.float32)),
    ("mc_fdct_quantize_rd", 8, 1),  # nh does not match the plane
    ("mc_fdct_quantize_rd", 11, torch.arange(4)),   # fid int64
    ("mc_idct_recon_skip", 0, torch.zeros((4, 12, 64), dtype=torch.int16)),
    ("mc_idct_recon_skip", 0, torch.zeros((2, 10, 64), dtype=torch.int16)),
    ("mc_idct_recon_skip", 3, torch.full((2, 1, 2, 64), 8,
                                         dtype=torch.int16)),
    ("mc_idct_recon_skip", 5, torch.zeros((3, 48, 40), dtype=torch.uint8)),
    ("mc_idct_recon_skip", 7, _misaligned(torch.zeros((12, 64),
                                                      dtype=torch.uint8))),
    ("mc_idct_recon_skip", 9, torch.zeros((12,), dtype=torch.uint8)),
    ("mc_idct_recon_skip", 10, torch.ones(3)),
    ("mc_idct_recon_skip", 11, torch.ones(12, dtype=torch.float64)),
    ("mc_idct_recon_skip", 13, _misaligned(torch.zeros((12, 64),
                                                       dtype=torch.int16))),
    ("mc_idct_recon_skip", 15, torch.zeros((12,), dtype=torch.int32)),
    ("mc_idct_recon_skip", 19, 3),   # pad_x below 8
    ("mc_idct_recon_skip", 21, torch.arange(7, dtype=torch.int32)),
])
def test_ks_fused_wrappers_reject_what_the_kernel_does_not_take(entry, which,
                                                                bad):
    """The fused wrappers refuse, for CPU tensors as for the card's,
    whatever their kernels do not take: a plane geometry, a dtype, a
    shape, a segment count, a misaligned source or plane, a fragment id
    list."""
    fn = _ks_fused(entry)
    args = list(_ks_fused_args(entry, "cpu"))
    fn(*args)  # the valid arguments are taken
    if which == len(args):
        args.append(bad)
    else:
        args[which] = bad
    with pytest.raises((TypeError, ValueError)):
        fn(*args)


# ------------------------------------------------------------- kernel KP

def _kp_args(device, nv=2, nh=3):
    rng = np.random.default_rng(8)
    t = lambda a: torch.from_numpy(a).to(device)
    return (t(rng.integers(0, 256, (8 * nv, 8 * nh), dtype=np.uint8)),
            t(rng.integers(0, 64, (nv, nh), dtype=np.uint8)),
            t(rng.integers(0, 64, (nv, nh), dtype=np.uint8)),
            t(rng.integers(0, 300, 64, dtype=np.int32)),
            t(-rng.integers(0, 30, 64, dtype=np.int32)), True, True, 0)


def _kp_frames_args(device, F=3, nv=2, nh=3):
    """postprocess_frames' arguments: frames 0 and 2 of an [F, h, w]
    output postprocessed from padded planes' images, dering on (strong)
    and off."""
    rng = np.random.default_rng(9)
    t = lambda a: torch.from_numpy(a).to(device)
    h, w = 8 * nv, 8 * nh
    srcs = []
    for _ in range(2):
        big = t(rng.integers(0, 256, (h + 16, w + 32), dtype=np.uint8))
        srcs.append(big[8:8 + h, 16:16 + w])
    return (srcs, [2, 0], torch.zeros((F, h, w), dtype=torch.uint8,
                                      device=device),
            t(rng.integers(0, 64, (F, 2, nv, nh), dtype=np.uint8)),
            t(rng.integers(0, 300, 64, dtype=np.int32)),
            t(-rng.integers(0, 30, 64, dtype=np.int32)), [True, False],
            [True, False], 0)


def _kp_cpu_only(monkeypatch, entry, make, plain_calls):
    """entry runs the plain version for CPU tensors only, raises on
    another device rather than falling back to it, counts no CPU call as
    a launch, and its module holds no try."""
    from theora_tpu_torch.ops import postproc, postproc_cuda

    calls = []

    def plain(src, *args):
        calls.append(src.device.type)
        return src.clone()

    monkeypatch.setattr(postproc, "postprocess_plane", plain)
    fn = getattr(postproc_cuda, entry)
    fn(*make("cpu"))
    assert calls == ["cpu"] * plain_calls
    with pytest.raises(ValueError, match="unsupported device"):
        fn(*make("meta"))
    assert calls == ["cpu"] * plain_calls
    assert postproc_cuda.postprocess_plane.launches == 0
    assert postproc_cuda.postprocess_frames.launches == 0
    tree = _parse(postproc_cuda.__file__)
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)]


def test_kp_plain_path_only_for_cpu_tensors(monkeypatch):
    _kp_cpu_only(monkeypatch, "postprocess_plane", _kp_args, 1)


def test_kp_frames_plain_path_only_for_cpu_tensors(monkeypatch):
    """The frame-axis entry too: its CPU path is one plain call per
    listed frame; a tensor on another device raises."""
    _kp_cpu_only(monkeypatch, "postprocess_frames", _kp_frames_args, 2)


def test_kp_frames_output_on_cpu():
    """postprocess_frames' CPU path writes each listed frame's plain call
    into its frame of out and leaves the other frames as they were."""
    from theora_tpu_torch.ops import postproc, postproc_cuda

    srcs, frames, out, ppq, scale, sharp, dering, strong, pli = \
        _kp_frames_args("cpu")
    out.fill_(9)
    got = postproc_cuda.postprocess_frames(srcs, frames, out, ppq, scale,
                                           sharp, dering, strong, pli)
    assert got is out
    for src, f, d, s in zip(srcs, frames, dering, strong):
        want = postproc.postprocess_plane(src, ppq[f, 0], ppq[f, 1], scale,
                                          sharp, d, s, pli)
        assert torch.equal(out[f], want)
    assert (out[1] == 9).all()


def _bad_frames(which):
    """_kp_frames_args with one argument made bad."""
    args = list(_kp_frames_args("cpu"))
    srcs = list(args[0])
    bad = {
        "src dtype": lambda: srcs.__setitem__(0, srcs[0].to(torch.int16)),
        "src shape": lambda: srcs.__setitem__(0, srcs[0][:, :16]),
        "src stride": lambda: srcs.__setitem__(
            0, torch.zeros((24, 16), dtype=torch.uint8).t()),
        "src device": lambda: srcs.__setitem__(
            0, torch.zeros((16, 24), dtype=torch.uint8, device="meta")),
        "src not a tensor": lambda: srcs.__setitem__(
            0, np.zeros((16, 24), np.uint8)),
        "out dtype": lambda: args.__setitem__(
            2, torch.zeros((3, 16, 24), dtype=torch.int16)),
        "out 2-d": lambda: args.__setitem__(
            2, torch.zeros((16, 24), dtype=torch.uint8)),
        "out width": lambda: args.__setitem__(
            2, torch.zeros((3, 16, 20), dtype=torch.uint8)),
        "out too wide": lambda: args.__setitem__(
            2, torch.zeros((1, 8, 16392), dtype=torch.uint8)),
        "out column stride": lambda: args.__setitem__(
            2, torch.zeros((3, 16, 48), dtype=torch.uint8)[:, :, ::2]),
        "out frames overlap": lambda: args.__setitem__(
            2, torch.zeros((16, 24), dtype=torch.uint8)[None].expand(
                3, 16, 24)),
        "ppq frames": lambda: args.__setitem__(
            3, torch.zeros((2, 2, 2, 3), dtype=torch.uint8)),
        "ppq dtype": lambda: args.__setitem__(
            3, torch.zeros((3, 2, 2, 3), dtype=torch.int32)),
        "table dtype": lambda: args.__setitem__(
            4, torch.zeros(64, dtype=torch.int64)),
        "too few frame indices": lambda: args.__setitem__(1, [2]),
        "too many flags": lambda: args.__setitem__(6, [True, True, False]),
        "too few strong flags": lambda: args.__setitem__(7, [True]),
        "no frames": lambda: (srcs.clear(), args.__setitem__(1, []),
                              args.__setitem__(6, []),
                              args.__setitem__(7, [])),
        "index out of range": lambda: args.__setitem__(1, [3, 0]),
        "index repeats": lambda: args.__setitem__(1, [0, 0]),
        "index a bool": lambda: args.__setitem__(1, [True, 0]),
        "flag not a bool": lambda: args.__setitem__(6, [1, 0]),
        "pli": lambda: args.__setitem__(8, 3),
    }[which]
    bad()
    args[0] = srcs
    return args


@pytest.mark.parametrize("which", [
    "src dtype", "src shape", "src stride", "src device",
    "src not a tensor", "out dtype", "out 2-d", "out width", "out too wide",
    "out column stride", "out frames overlap", "ppq frames", "ppq dtype",
    "table dtype", "too few frame indices", "too many flags",
    "too few strong flags", "no frames", "index out of range",
    "index repeats", "index a bool", "flag not a bool", "pli"])
def test_kp_frames_wrapper_rejects_what_the_kernels_do_not_take(which):
    """postprocess_frames raises on a bad shape, dtype, stride, device,
    descriptor count, frame index, flag or plane index."""
    from theora_tpu_torch.ops import postproc_cuda

    postproc_cuda.postprocess_frames(*_kp_frames_args("cpu"))
    with pytest.raises((TypeError, ValueError)):
        postproc_cuda.postprocess_frames(*_bad_frames(which))


def test_kp_wrapper_output_on_cpu():
    """The CPU path is the plain version; with out given it writes there,
    a padded plane's row-strided image is taken as it is."""
    from theora_tpu_torch.ops import postproc, postproc_cuda

    args = _kp_args("cpu")
    want = postproc.postprocess_plane(*args)
    assert torch.equal(postproc_cuda.postprocess_plane(*args), want)
    big = torch.zeros((32, 56), dtype=torch.uint8)
    big[8:24, 16:40] = args[0]
    out = torch.zeros((20, 30), dtype=torch.uint8)
    got = postproc_cuda.postprocess_plane(big[8:24, 16:40], *args[1:],
                                          out=out[2:18, 3:27])
    assert torch.equal(got, want) and torch.equal(out[2:18, 3:27], want)
    assert not out[:2].any() and not out[:, :3].any()


@pytest.mark.parametrize("which,bad", [
    (0, torch.zeros((16, 24), dtype=torch.int16)),
    (0, torch.zeros((16, 20), dtype=torch.uint8)),
    (0, torch.zeros((12, 24), dtype=torch.uint8)),
    (0, torch.zeros((24, 16), dtype=torch.uint8).t()),
    (0, torch.zeros((16, 48), dtype=torch.uint8)[:, ::2]),
    (0, torch.zeros((16,), dtype=torch.uint8)),
    (0, torch.zeros((8, 16392), dtype=torch.uint8)),
    (0, np.zeros((16, 24), np.uint8)),
    (1, torch.zeros((2, 3), dtype=torch.int32)),
    (1, torch.zeros((3, 2), dtype=torch.uint8)),
    (1, torch.zeros((2, 6), dtype=torch.uint8)[:, ::2]),
    (2, torch.zeros((2, 4), dtype=torch.uint8)),
    (2, torch.zeros((2, 3), dtype=torch.uint8, device="meta")),
    (3, torch.zeros(64, dtype=torch.int64)),
    (3, torch.zeros(63, dtype=torch.int32)),
    (4, torch.zeros(64, dtype=torch.float32)),
    (8, torch.zeros((16, 24), dtype=torch.int16)),
    (8, torch.zeros((16, 32), dtype=torch.uint8)),
    (8, torch.zeros((24, 16), dtype=torch.uint8).t()),
])
def test_kp_wrapper_rejects_what_the_kernel_does_not_take(which, bad):
    from theora_tpu_torch.ops import postproc_cuda

    args = list(_kp_args("cpu"))
    if which == len(args):
        args.append(bad)
    else:
        args[which] = bad
    with pytest.raises((TypeError, ValueError)):
        postproc_cuda.postprocess_plane(*args)


def test_repeats_are_copied_after_kp_in_frame_order(monkeypatch):
    """A frame that repeats the last output (it codes no block after a
    postprocessed frame) is left out of the batch's postprocess_frames call
    and copied after it, in frame order: a repeat, and a repeat of a
    repeat, show the postprocessed frame before them, the first frame of
    the next batch repeats the last output of the one before, and the
    references are not touched. The repeats are marked on clip64x48_k8_q5's
    live frames at level 7."""
    from theora_tpu_torch.decode.batch import BatchDecoder
    from theora_tpu_torch.headers import parse_info_header, \
        parse_setup_header
    from theora_tpu_torch.ops import postproc_cuda
    from theora_tpu_torch.tpkt import read_tpkt

    pkts = read_tpkt(os.path.join(TESTDATA, "clip64x48_k8_q5.tpkt"))
    info = parse_info_header(pkts[0].data)
    setup = parse_setup_header(pkts[2].data)
    datas = [p.data for p in pkts[3:11]]

    def decode(marked):
        dec = BatchDecoder(info, setup, device="cpu")
        dec.set_pplevel(7)
        return [b"".join(np.ascontiguousarray(p).tobytes() for p in f)
                for f in dec.decode_clip(datas, batch=4)]

    want = decode(None)
    real_inputs = BatchDecoder._plane_inputs
    calls = []
    real_pp = postproc_cuda.postprocess_frames

    seen = []

    def inputs(self, live, pli):
        inp = real_inputs(self, live, pli)
        # Batch 1: frames 2 and 3 repeat frame 1; batch 2: frame 0
        # repeats batch 1's last output (frame 1's), frame 3 frame 2.
        seen.append(pli)
        inp["repeat"] = [f in ((2, 3) if len(seen) <= 3 else (0, 3))
                         for f in range(len(live))]
        return inp

    def spy(srcs, frames, out, *rest):
        calls.append((rest[-1], tuple(frames)))
        return real_pp(srcs, frames, out, *rest)

    monkeypatch.setattr(BatchDecoder, "_plane_inputs", inputs)
    monkeypatch.setattr(postproc_cuda, "postprocess_frames", spy)
    got = decode(True)
    assert calls == [(pli, (0, 1)) for pli in range(3)] + [
        (pli, (1, 2)) for pli in range(3)]
    assert got[:2] == want[:2] and got[2] == got[3] == want[1]
    assert got[4] == want[1] and got[5:7] == want[5:7] and got[7] == want[6]


def test_kp_build_is_sm90a(monkeypatch, tmp_path):
    """KP's library is built by nvcc_build from csrc/postproc.cu for
    sm_90a, without fast math (its arithmetic is integer). Nothing is
    compiled: subprocess.run is replaced."""
    import subprocess

    from theora_tpu_torch.ops import cuda_build, postproc_cuda

    calls = []

    def run(cmd, **kwargs):
        calls.append(cmd)
        return subprocess.CompletedProcess(cmd, 0, "", "ptxas info")

    monkeypatch.setattr(cuda_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(subprocess, "run", run)
    monkeypatch.setattr(postproc_cuda, "_SO",
                        str(tmp_path / "build" / "libtheora_postproc.so"))
    so = postproc_cuda.build()
    assert len(calls) == 1
    cmd = calls[0]
    assert cmd[0] == "nvcc"
    assert cmd[cmd.index("-gencode") + 1] == "arch=compute_90a,code=sm_90a"
    assert not any("fast_math" in c or "fast-math" in c for c in cmd)
    assert cmd[-1] == postproc_cuda._SRC
    assert cmd[-1].endswith(os.path.join("csrc", "postproc.cu"))
    assert so == postproc_cuda._SO and os.path.exists(so)


def test_decoders_reach_kp_and_nothing_calls_the_plain_postprocessor(
        monkeypatch):
    """With a pp level set, the decoders postprocess through
    postproc_cuda.postprocess_frames, once per plane per decoded batch
    (per packet: one frame): at level 7 every frame of the batch from the
    first keyframe, with the dering on and strong, into the batch's
    output frames, from the padded reference planes' images; at level 4
    luma only; at level 0 never. No module of the port but the wrapper
    calls ops/postproc.py's filter (the tools and chip_smoke.py call it
    to hold the kernel against it). The new modules import neither JAX
    nor the JAX package."""
    from theora_tpu_torch.decode.batch import BatchDecoder
    from theora_tpu_torch.decode.scalar import PacketDecoder
    from theora_tpu_torch.headers import parse_info_header, \
        parse_setup_header
    from theora_tpu_torch.ops import postproc_cuda
    from theora_tpu_torch.tpkt import read_tpkt

    calls = []
    real = postproc_cuda.postprocess_frames

    def spy(srcs, frames, out, ppq, scale, sharp, dering, strong, pli):
        calls.append((pli, tuple(frames), tuple(dering), tuple(strong),
                      out.shape[0],
                      all(s.stride(0) > s.shape[1] for s in srcs)))
        return real(srcs, frames, out, ppq, scale, sharp, dering, strong,
                    pli)

    monkeypatch.setattr(postproc_cuda, "postprocess_frames", spy)
    pkts = read_tpkt(os.path.join(TESTDATA, "clip64x48_k8_q5.tpkt"))
    info = parse_info_header(pkts[0].data)
    setup = parse_setup_header(pkts[2].data)
    datas = [p.data for p in pkts[3:]]
    batches = [len(datas[i:i + 3]) for i in range(0, len(datas), 3)]
    for level, plis in ((7, (0, 1, 2)), (4, (0,)), (0, ())):
        calls.clear()
        dec = BatchDecoder(info, setup, device="cpu")
        dec.set_pplevel(level)
        assert len(dec.decode_clip(datas, batch=3)) == len(datas)
        # A batch runs plane by plane, each over its frames.
        assert calls == [(pli, tuple(range(n)), (True,) * n, (True,) * n, n,
                          True) for n in batches for pli in plis]
        calls.clear()
        pd = PacketDecoder(info, setup, device="cpu")
        pd.set_pplevel(level)
        for d in datas[:2]:
            pd.decode_packet(d)
        assert calls == [(pli, (0,), (True,), (True,), 1, True)
                         for pli in plis] * 2

    new = ("ops/postproc.py", "ops/postproc_cuda.py", "decode/telemetry.py",
           "compat.py", "tools/bench_pp.py")
    sources = list(_port_sources())
    for rel in new:
        path = os.path.join(REPO_ROOT, "theora_tpu_torch", rel)
        assert path in sources
        assert not [m for m in _imported_modules(path)
                    if m.split(".")[0] in FORBIDDEN], rel
    for path in sources:
        rel = os.path.relpath(path, REPO_ROOT)
        if rel in (os.path.join("theora_tpu_torch", "ops",
                                "postproc_cuda.py"), "chip_smoke.py") or \
                rel.startswith(os.path.join("theora_tpu_torch", "tools")):
            continue
        for n in ast.walk(_parse(path)):
            if isinstance(n, ast.ImportFrom) and n.module:
                names = {a.name for a in n.names}
                assert not (n.module.endswith("ops.postproc")
                            and "postprocess_plane" in names), rel
                assert not (n.module.endswith("ops")
                            and "postproc" in names), rel
