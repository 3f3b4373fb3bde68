"""Kernel KR's fused entry (qrd_cuda.fdct_quantize_rd: kernel K2's fDCT and
round-to-nearest quantization with the R/D quantizer's row step, one
launch) against the JAX package: on the CPU the wrapper runs its plain
version, transforms.fdct_quantize_rd, which must equal JAX `fdct8x8` and
`jax.jit(quantize_rd)` row by row, exactly, at K = 1, 2 and 3 qi rows and
over segments with their own rows and lambdas. Also the tables the CUDA
sources spell out, parsed from them: the zig-zag order of K2's block core
(csrc/fdct_core.cuh, which both kernels include) and the R/D quantizer's
lone-value bits (csrc/quantize_rd.cu)."""
import os
import re

import jax
import numpy as np
import pytest
import torch

from theora_tpu.ops import transforms_jax as tj
from theora_tpu_torch.constants import ZIGZAG_TO_NAT
from theora_tpu_torch.ops import fdct_cuda, qrd_cuda, transforms
from theora_tpu_torch.tools import bench_qrd, bench_segments

# The tests run in several worker processes on a few CPUs: one torch
# thread each (their tensors are small, and idle intra-op threads spin).
torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs in several worker processes on shared cores; these
    small tensors gain nothing from many intra-op threads."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


_jax_fdct = jax.jit(tj.fdct8x8)
_jax_qrd = jax.jit(tj.quantize_rd)


def _jax_fused(res, deq, inter, lam_q):
    """JAX fdct8x8, then quantize_rd (which quantizes round-to-nearest
    first) at each qi row: block b takes its segment's dequant row and
    lambda by its own type (intra or inter). Returns the [K, N, 64]
    values, [K, N] counts and DC-only flags as numpy arrays."""
    res, deq, inter, lam_q = (a.numpy() for a in (res, deq, inter, lam_q))
    deq = deq.reshape(-1, *deq.shape[-3:])       # [G, K, 2, 64]
    lam_q = lam_q.reshape(-1, *lam_q.shape[-2:])  # [G, K, 2]
    n = len(res)
    seg = np.arange(n) // (n // deq.shape[0])
    sel = (inter != 0).astype(np.int64)
    dct = np.asarray(_jax_fdct(res.reshape(n, 8, 8).astype(np.int32)))
    vals = np.stack([
        np.asarray(_jax_qrd(dct, deq[seg, k, sel].astype(np.int32),
                            lam_q[seg, k, sel]))
        for k in range(deq.shape[1])])
    nz = vals != 0
    cnt = nz.sum(axis=2)
    return vals, cnt, cnt - nz[:, :, 0] == 0, dct


def _segment_args(k):
    c = bench_segments.segment_case(np.random.default_rng(41), 600, 3,
                                    "cpu", scales=False)
    return (c["res"], c["deq"][:, :k].contiguous(), c["inter"],
            c["lam_q"][:, :k].contiguous())


@pytest.mark.parametrize("case", [
    "K = 1, luma", "K = 2, chroma", "K = 3, luma", "K = 3, chroma",
    "3 segments, K = 1", "3 segments, K = 3",
])
def test_fused_entry_equals_jax_row_by_row(case):
    """The fused wrapper on the CPU against JAX on seeded random residuals
    (bench_fdct.random_residuals, int16-safe extremes first) with intra
    and inter blocks mixed: at adaptive quantization's real qi lists of
    one, two and three rows (bench_qrd.qi_lists, DC at the base qi) for
    2,000 blocks, and over 3 segments of 600 blocks, each with its own qi
    triple and lambdas (bench_segments.segment_case). Values, counts and
    DC-only flags equal; the quantizer moves some values off
    round-to-nearest at every row."""
    if case.startswith("3 segments"):
        args = _segment_args(int(case[-1]))
    else:
        k = int(case[4])
        pli = 0 if case.endswith("luma") else 1
        args = bench_qrd.fused_args(np.random.default_rng(40 + k), 2000,
                                    bench_qrd.qi_lists()[k], pli, "cpu")
    vals, cnt, dc_only = qrd_cuda.fdct_quantize_rd(*args)
    want_vals, want_cnt, want_dc, dct = _jax_fused(*args)
    assert np.array_equal(vals.numpy(), want_vals)
    assert np.array_equal(cnt.numpy(), want_cnt)
    assert np.array_equal(dc_only.numpy(), want_dc)
    assert qrd_cuda.fdct_quantize_rd.launches == 0
    # Every row moved some values off round-to-nearest.
    q0, _ = transforms.fdct_quantize(*args[:3])
    assert ((vals != q0).any(dim=2).sum(dim=1) > 0).all()
    assert want_dc.any()
    assert np.array_equal(transforms.fdct8x8(
        args[0].reshape(-1, 8, 8).to(torch.int32)).numpy(), dct)


def test_fused_entry_equals_the_chain_it_replaces():
    """On the CPU the fused wrapper equals K2's wrapper followed by KR's
    standalone wrapper (the chain the encode scan ran), at K = 3 over
    3,600 blocks and over 2 segments."""
    args = bench_qrd.fused_args(np.random.default_rng(43), 3600,
                                bench_qrd.qi_lists()[3], 1, "cpu")
    seg = (args[0], torch.stack([args[1], args[1].flip(0)]), args[2],
           torch.stack([args[3], 2 * args[3]]))
    for a in (args, seg):
        got = qrd_cuda.fdct_quantize_rd(*a)
        q, d = fdct_cuda.fdct_quantize(*a[:3])
        want = qrd_cuda.quantize_rd(q, d, *a[1:])
        assert all(torch.equal(g, w) for g, w in zip(got, want))


def _src(*parts):
    with open(os.path.join(os.path.dirname(fdct_cuda._SRC), *parts)) as f:
        return f.read()


def test_source_tables_are_the_plain_versions():
    """The zig-zag table of K2's block core (fdct_core.cuh) is the plain
    version's ZIGZAG_TO_NAT, and no kernel source keeps a copy of its
    own: K2 and KR include the header. KR's lone-value bits (mag_bits2 in
    quantize_rd.cu: twice the bits, bytes of two words below magnitude 8
    and a constant from 8 on) halved give transforms._MAG_BITS at
    magnitudes 0-8 and its last entry above."""
    core = _src("fdct_core.cuh")
    body = core[core.index("kZigToNat[64] = {"):]
    body = body[body.index("{") + 1:body.index("};")]
    assert [int(x) for x in body.split(",")] == ZIGZAG_TO_NAT.tolist()
    for name in ("fdct_quant.cu", "quantize_rd.cu"):
        src = _src(name)
        assert '#include "fdct_core.cuh"' in src
        assert "kZigToNat[64]" not in src and "void fdct8(" not in src

    src = _src("quantize_rd.cu")
    consts = {name: int(value, 0) for name, value in re.findall(
        r"constexpr u?int(?:32_t)? (kBits2\w+) = (0x[0-9A-Fa-f]+|\d+)u?;",
        src)}
    table = consts["kBits2Lo"] | consts["kBits2Hi"] << 32

    def bits(a):
        """mag_bits2(a) / 2: byte a of the table below 8."""
        return (consts["kBits2Max"] if a >= 8
                else table >> 8 * a & 0xFF) / 2

    assert "__byte_perm(kBits2Lo, kBits2Hi, (unsigned)a)" in src
    assert [bits(a) for a in range(9)] == transforms._MAG_BITS.tolist()
    assert bits(40) == transforms._MAG_BITS[8]
