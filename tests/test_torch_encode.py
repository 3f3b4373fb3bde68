"""The device GOP encoder of the PyTorch port as a whole, on the CPU:
`GopEncoder(device="cpu")` against the JAX `TpuGopEncoder` at a fixed qi
with the trellis and adaptive_quant=False on both sides, byte-identical
packets, headers included (the JAX encodes' packets, granule positions,
packet numbers and flags are the committed record
testdata/enc64x48_cases.pkts, which testdata/make_hd720_enc.py makes from
the same cases); its closed-loop reconstruction against the port's own
decoder; the encoder CLI against the JAX package's (its output's
SHA-256, testdata/cli_cases.sha256); the port's tables.
Adaptive quantization, the default, is held to JAX in
tests/test_torch_adaptive.py."""
import hashlib
import importlib.util
import os

import numpy as np
import pytest
import torch

from tests.conftest import TESTDATA

# The tests run in several worker processes on a few CPUs: one torch
# thread each (their tensors are small, and idle intra-op threads spin).
torch.set_num_threads(1)

_spec = importlib.util.spec_from_file_location(
    "make_hd720_enc", os.path.join(TESTDATA, "make_hd720_enc.py"))
make_enc = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(make_enc)

@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs in several worker processes on shared cores; these
    small tensors gain nothing from many intra-op threads."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


# name -> (pixel_fmt, qi, keyframe_freq, frames): the generator's cases.
CASES = {name: (fmt, qi, kf, frames())
         for name, (fmt, qi, kf, frames) in make_enc.ENC_CASES.items()}


def _info(mod, fmt, qi):
    return mod.TheoraInfo(frame_width=64, frame_height=48, pic_width=64,
                          pic_height=48, quality=qi, pixel_fmt=fmt)


@pytest.fixture(scope="module")
def jax_packets():
    """The JAX encode of each case, as the committed record gives it:
    {case: [(SHA-256, granulepos, packetno, b_o_s, e_o_s)]}."""
    return make_enc.read_records("enc64x48_cases.pkts")


def _port_encoder(fmt, qi, **kw):
    """The port's encoder in the JAX twins' configuration:
    adaptive_quant=False, as jax_packets sets it."""
    from theora_tpu_torch import info
    from theora_tpu_torch.encode.gop import GopEncoder

    return GopEncoder(_info(info, fmt, qi), qi=qi, device="cpu",
                      adaptive_quant=False, **kw)


@pytest.mark.parametrize("name", list(CASES))
def test_encode_clip_packets_equal_jax(jax_packets, name):
    fmt, qi, kf, frames = CASES[name]
    got = _port_encoder(fmt, qi).encode_clip(frames, keyframe_freq=kf,
                                             clip_batch=8)
    want = jax_packets[name]
    assert len(got) == len(want) == 3 + len(frames)
    for i, (a, b) in enumerate(zip(make_enc.record_of(got), want)):
        assert a == b, f"packet {i}"
    if name == "fmt0":
        # The committed list chip_smoke.py holds the card to.
        with open(os.path.join(TESTDATA, "enc64x48.sha256")) as f:
            hashes = f.read().split()
        assert [hashlib.sha256(p.data).hexdigest() for p in got] == \
            hashes[:len(got)]


def test_encode_clip_with_passed_tables(jax_packets):
    """qinfo and huff_codes reach the port from the JAX package's
    tables, the encoder's counterpart of carrying weights across."""
    from theora_tpu import tables as jtables

    fmt, qi, kf, frames = CASES["fmt2"]
    enc = _port_encoder(fmt, qi, qinfo=jtables.DEF_QUANT_INFO,
                        huff_codes=jtables.VP31_HUFF_CODES)
    got = enc.encode_clip(frames, keyframe_freq=kf)
    assert [r[0] for r in make_enc.record_of(got)] == \
        [r[0] for r in jax_packets["fmt2"]]


@pytest.mark.parametrize("name", ["fmt0", "fmt2", "fmt3", "clip64x48"])
def test_closed_loop_equals_port_decoder(name):
    """The reconstruction carried through the encode equals what the
    port's own BatchDecoder decodes from the packets, frame for frame."""
    from theora_tpu_torch.decode.batch import BatchDecoder
    from theora_tpu_torch.headers import parse_info_header, \
        parse_setup_header

    fmt, qi, _, frames = CASES[name]
    enc = _port_encoder(fmt, qi)
    datas, recon = enc.encode_gop(frames, want_recon=True)
    hdr = enc.flush_headers()
    dec = BatchDecoder(parse_info_header(hdr[0].data),
                       parse_setup_header(hdr[2].data), device="cpu")
    outs = dec.decode_clip(datas, batch=3)
    g = enc.g
    for f, out in enumerate(outs):
        for pli in range(3):
            vpad, hpad = g.plane_padding(pli)
            h, w = g.plane_shape(pli)
            plane = recon[pli][f][vpad:vpad + h, hpad:hpad + w][::-1]
            assert np.array_equal(plane, out[pli]), (f, pli)


def test_encoder_cli_equals_jax_cli(tmp_path):
    """python -m theora_tpu_torch.tools.enc --device cpu writes the same
    .ogv as the JAX CLI's device tier (its SHA-256, the committed
    testdata/cli_cases.sha256), for a picture that is not a multiple of
    16 (edge-padded frame, crop rectangle); 9 frames at -k 8 end on a
    one-frame chunk, which runs no ME."""
    import hashlib

    from theora_tpu_torch.tools import enc as tenc
    from theora_tpu_torch.tools.y4m import write_y4m

    name = "clip60x44_q36_k8_aq_off"
    frames, flags = make_enc.CLI_CASES[name]
    y4m, b = str(tmp_path / "in.y4m"), str(tmp_path / "port.ogv")
    write_y4m(y4m, frames())
    tenc.main(["--device", "cpu", *flags, y4m, b])
    with open(b, "rb") as fb:
        assert hashlib.sha256(fb.read()).hexdigest() == \
            make_enc.read_cli()[name]


def test_tables_equal_jax_package():
    from theora_tpu import tables as jtables
    from theora_tpu.constants import DCT_TOKEN_EXTRA_BITS, MODE_ALPHABETS
    from theora_tpu.encode.encoder import _ZZI_GROUP
    from theora_tpu_torch import constants, tables

    assert tables.DEF_QUANT_INFO == jtables.DEF_QUANT_INFO
    assert tables.VP31_HUFF_CODES == jtables.VP31_HUFF_CODES
    assert tables.RD_LAMBDA == jtables.RD_LAMBDA
    assert np.array_equal(constants.DCT_TOKEN_EXTRA_BITS,
                          DCT_TOKEN_EXTRA_BITS)
    assert np.array_equal(constants.MODE_ALPHABETS, MODE_ALPHABETS)
    assert np.array_equal(constants.ZZI_GROUP, _ZZI_GROUP)
