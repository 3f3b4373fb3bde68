"""Tests of the port that need a CUDA card (marker `cuda`); they skip
with a reason where there is none. This file imports no JAX, so it runs
on the GPU machine:

    python -m pytest tests/test_torch_card.py -m cuda
"""
import os

import numpy as np
import pytest
import torch

from theora_tpu_torch.ops import idct_cuda, transforms

# Not imported from tests.conftest: on a machine where site-packages holds
# a regular `tests` package, it shadows this directory's namespace one.
TESTDATA = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "testdata")

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1, K2, KT and the device decode "
                    "and encode paths have no CPU mode")
    return torch.device("cuda")


def test_k1_kernel_matches_plain(card):
    rng = np.random.default_rng(21)
    n, nframes = 5000, 4

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(card)

    args = (
        t(rng.integers(-32768, 32768, (n, 64), dtype=np.int16)),
        t(rng.integers(-32768, 32768, n, dtype=np.int16)),
        t(rng.integers(1, 32768, (nframes, 3, 2, 64), dtype=np.int16)),
        t(np.sort(rng.integers(0, nframes, n)).astype(np.int32)),
        t(rng.integers(0, 3, n).astype(np.uint8)),
        t(rng.integers(0, 2, n).astype(np.uint8)),
        t(rng.random(n) < 0.3),
    )
    before = idct_cuda.dequantize_idct_frames.launches
    got = idct_cuda.dequantize_idct_frames(*args)
    torch.cuda.synchronize()
    assert idct_cuda.dequantize_idct_frames.launches == before + 1
    assert torch.equal(got, transforms.dequantize_idct_frames(*args))


@pytest.mark.parametrize("name", ["clip64x48_k8_q5", "clip444"])
def test_golden_stream_on_card(card, name):
    from theora_tpu_torch.decode.batch import BatchDecoder
    from theora_tpu_torch.headers import parse_info_header, \
        parse_setup_header
    from theora_tpu_torch.tpkt import read_tpkt

    pkts = read_tpkt(os.path.join(TESTDATA, f"{name}.tpkt"))
    dec = BatchDecoder(parse_info_header(pkts[0].data),
                       parse_setup_header(pkts[2].data))
    outs = dec.decode_clip([p.data for p in pkts[3:]], batch=3)
    ref = np.fromfile(os.path.join(TESTDATA, f"{name}.ref.yuv"),
                      np.uint8).reshape(len(outs), -1)
    for i, o in enumerate(outs):
        assert np.array_equal(np.concatenate([p.reshape(-1) for p in o]),
                              ref[i]), f"frame {i}"


def test_k2_kernel_matches_plain(card):
    from theora_tpu_torch.ops import fdct_cuda

    rng = np.random.default_rng(22)
    n = 14400

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(card)

    args = (t(rng.integers(-255, 256, (n, 64)).astype(np.int16)),
            t(rng.integers(8, 4097, (2, 64)).astype(np.int16)),
            t(rng.integers(0, 2, n).astype(np.uint8)))
    before = fdct_cuda.fdct_quantize.launches
    q, d = fdct_cuda.fdct_quantize(*args)
    torch.cuda.synchronize()
    assert fdct_cuda.fdct_quantize.launches == before + 1
    qp, dp = transforms.fdct_quantize(*args)
    assert torch.equal(q, qp) and torch.equal(d, dp)


def test_kt_kernel_matches_plain(card):
    """KT on K2's outputs for 3,600 random residual blocks (one chroma
    plane of a 720p frame) at a random qi, an intra and an inter frame,
    exact: values, nonzero counts and DC-only flags."""
    from theora_tpu_torch import tables
    from theora_tpu_torch.encode.gop import trellis_bit_costs
    from theora_tpu_torch.ops import fdct_cuda, trellis_cuda
    from theora_tpu_torch.quant import dequant_tables_init

    rng = np.random.default_rng(23)
    n = 3600
    qi = int(rng.integers(0, 64))
    deq = dequant_tables_init(tables.DEF_QUANT_INFO)[qi, 1].astype(np.int16)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(card)

    nb = t(trellis_bit_costs(tables.VP31_HUFF_CODES))
    for qti in (0, 1):
        inter = (np.zeros(n, np.uint8) if qti == 0
                 else rng.integers(0, 2, n).astype(np.uint8))
        res = rng.integers(-255, 256, (n, 64)) // rng.integers(1, 40, (n, 1))
        q, d = fdct_cuda.fdct_quantize(t(res.astype(np.int16)), t(deq),
                                       t(inter))
        args = (q, d, t(deq), t(inter),
                np.float32(tables.RD_LAMBDA[0][qti][qi]), nb)
        before = trellis_cuda.trellis_quantize.launches
        got = trellis_cuda.trellis_quantize(*args)
        torch.cuda.synchronize()
        assert trellis_cuda.trellis_quantize.launches == before + 1
        want = transforms.trellis_quantize(*args)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        assert bool((want[0] != q).any())  # the trellis moved some


def test_encode_on_card_equals_cpu(card):
    import importlib.util

    from theora_tpu_torch.encode.gop import GopEncoder
    from theora_tpu_torch.info import TheoraInfo

    spec = importlib.util.spec_from_file_location(
        "make_hd720_enc", os.path.join(TESTDATA, "make_hd720_enc.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    frames = mod.moving_frames(64, 48, 0, 5, 11)
    info = TheoraInfo(frame_width=64, frame_height=48, pic_width=64,
                      pic_height=48, quality=40)
    on_card = GopEncoder(info, qi=40).encode_clip(frames, keyframe_freq=4)
    on_cpu = GopEncoder(info, qi=40, device="cpu").encode_clip(
        frames, keyframe_freq=4)
    assert [p.data for p in on_card] == [p.data for p in on_cpu]
