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
        pytest.skip("needs a CUDA card: K1 and the device decode path "
                    "have no CPU mode")
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
