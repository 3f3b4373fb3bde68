"""The port's device-resident transcode, its staged and pipelined encoder
and its per-packet decoder on the CPU, against lists the JAX package made
(testdata/make_hd720_enc.py: JAX transcode_device, or, for a dup that
leads a batch, the JAX host Decoder fed to TpuGopEncoder.encode_clip),
libtheora's golden output and the JAX host Decoder. Exact equality. No
test runs JAX's tpu_gop: it takes 11-48 s a call on the CPU."""
import hashlib
import importlib.util
import os

import numpy as np
import pytest
import torch

from tests.conftest import TESTDATA
from theora_tpu.decode.decoder import Decoder as JaxHostDecoder
from theora_tpu.headers import parse_info_header as jax_info
from theora_tpu.headers import parse_setup_header as jax_setup
from theora_tpu_torch.decode.scalar import PacketDecoder
from theora_tpu_torch.encode import gop
from theora_tpu_torch.encode.gop import GopEncoder, transcode_device
from theora_tpu_torch.headers import parse_info_header, parse_setup_header
from theora_tpu_torch.info import TheoraInfo
from theora_tpu_torch.tpkt import read_tpkt

_spec = importlib.util.spec_from_file_location(
    "make_hd720_enc", os.path.join(TESTDATA, "make_hd720_enc.py"))
mk = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(mk)

GOLDEN = ["cif_k4_q40", "cif_cbr", "clip422", "clip444", "crop80x64",
          "clip64x48_k8_q5"]


def _stream(name):
    pkts = read_tpkt(os.path.join(TESTDATA, name))
    return (parse_info_header(pkts[0].data),
            parse_setup_header(pkts[2].data), [p.data for p in pkts[3:]])


def _hashes_equal(pkts, name):
    with open(os.path.join(TESTDATA, name)) as f:
        want = f.read().split()
    got = [hashlib.sha256(p.data).hexdigest() for p in pkts]
    assert len(got) == len(want)
    assert [i for i, (a, b) in enumerate(zip(got, want)) if a != b] == []


def _flat(frame):
    return np.concatenate([p.reshape(-1) for p in frame])


# ------------------------------------------------------------ transcode

@pytest.mark.parametrize("case", ["k6", "dup", "cbr"])
def test_transcode_equals_jax_list(case):
    """k6: batches of 6 and 2 packets, pipelined; dup: a dup in
    mid-batch, one leading a batch (fault F3 of the JAX function: the
    list holds the host decode's frame) and a batch of dups only; cbr: 4
    GOPs in turn under the rate controller, whose qi moves."""
    info, setup, datas = _stream(mk.TC_SOURCE)
    kw = {"k6": dict(keyframe_freq=mk.TC_KF),
          "dup": dict(keyframe_freq=mk.TC_DUP_KF),
          "cbr": dict(keyframe_freq=mk.TC_CBR_KF,
                      target_bitrate=mk.TC_CBR_RATE, rate_window=1)}[case]
    if case == "dup":
        datas = mk.dup_packets(datas)
    out = transcode_device(info, setup, datas, qi=mk.TC_QI,
                           enc_kwargs={"device": "cpu"}, **kw)
    _hashes_equal(out, f"transcode64x48_{case}_enc.sha256")
    qis = {p.data[0] & 0x3F for p in out[3:] if p.data}
    assert (len(qis) > 1) == (case == "cbr")


def test_transcode_dup_before_any_frame_raises():
    info, setup, datas = _stream(mk.TC_SOURCE)
    with pytest.raises(ValueError, match="start with a live frame"):
        transcode_device(info, setup, [b""] + datas, keyframe_freq=4,
                         enc_kwargs={"device": "cpu"})


def test_device_planes_are_checked():
    enc = GopEncoder(TheoraInfo(frame_width=64, frame_height=48,
                                pic_width=64, pic_height=48, quality=40),
                     device="cpu")
    good = {0: torch.zeros((2, 48, 64), dtype=torch.uint8),
            1: torch.zeros((2, 24, 32), dtype=torch.uint8),
            2: torch.zeros((2, 24, 32), dtype=torch.uint8)}
    enc.finish_gop(enc.dispatch_gop(device_planes=good))
    for pli, bad in ((0, torch.zeros((2, 48, 64), dtype=torch.int16)),
                     (1, torch.zeros((2, 24, 31), dtype=torch.uint8)),
                     (2, torch.zeros((1, 24, 32), dtype=torch.uint8))):
        with pytest.raises(ValueError, match=f"device_planes\\[{pli}\\]"):
            enc.dispatch_me(device_planes={**good, pli: bad})


# ------------------------------------------------------ staged encoder

def test_pipelined_encode_clip_three_chunks(monkeypatch):
    """GOPs at 0, 8 and 9 (a scene cut), one chunk each: the stages run
    two deep in JAX's order, both queues drain inside the loop, and the
    packets equal the JAX encoder's."""
    calls = []
    for stage in ("dispatch_me", "complete_dispatch", "finish_gop"):
        def wrap(self, *a, _f=getattr(GopEncoder, stage), _s=stage, **k):
            calls.append(_s)
            return _f(self, *a, **k)
        monkeypatch.setattr(GopEncoder, stage, wrap)
    enc = GopEncoder(TheoraInfo(frame_width=64, frame_height=48,
                                pic_width=64, pic_height=48,
                                quality=mk.SMALL_QI), qi=mk.SMALL_QI,
                     device="cpu")
    pkts = enc.encode_clip(mk.cut_frames(), keyframe_freq=mk.CUT_KF,
                           auto_keyframe=True, clip_batch=1)
    _hashes_equal(pkts, "cut64x48_autokf_enc.sha256")
    d, c, f = "dispatch_me", "complete_dispatch", "finish_gop"
    assert calls == [d, d, c, d, c, f, c, f, f]


def test_nonzeros_index_the_chunk_blocks():
    """A plane's nonzero coefficients, int16 extremes included, land at
    their places among all planes' blocks of each frame."""
    rng = np.random.RandomState(3)
    q = rng.randint(-32768, 32768, (3, 50, 64)).astype(np.int16)
    q[rng.rand(*q.shape) < 0.9] = 0
    q[0, 0, :2] = (-32768, 32767)
    idx, vals = (t.numpy() for t in gop._nonzeros(torch.from_numpy(q), 7,
                                                    80))
    assert idx.dtype == np.int32 and vals.dtype == np.int16
    out = np.zeros((3, 80, 64), np.int16)
    out.reshape(-1)[idx] = vals
    assert np.array_equal(out[:, 7:57], q)
    assert np.count_nonzero(out) == np.count_nonzero(q)
    empty = gop._nonzeros(torch.zeros((2, 1, 64), dtype=torch.int16), 0, 1)
    assert [t.numel() for t in empty] == [0, 0]


def test_plan_narrowing_is_exact_over_its_range():
    outs = []
    for i in range(11):
        lo, hi = (-31, 31) if i in gop._PLAN_VECTORS else (0, 65280)
        outs.append(torch.tensor([lo, hi, (lo + hi) // 2, lo + 1],
                                 dtype=torch.int32))
    back = gop._widen_plan([t.numpy() for t in gop._narrow_plan(outs)])
    for o, b in zip(outs, back):
        assert b.dtype == np.int32 and np.array_equal(o.numpy(), b)


# ------------------------------------------------- per-packet decoder

@pytest.mark.parametrize("name", GOLDEN)
def test_packet_decoder_equals_golden(name):
    info, setup, datas = _stream(f"{name}.tpkt")
    ref = np.fromfile(os.path.join(TESTDATA, f"{name}.ref.yuv"),
                      np.uint8).reshape(len(datas), -1)
    dec = PacketDecoder(info, setup, device="cpu")
    for i, data in enumerate(datas):
        assert dec.decode_packet(data) == 0
        assert np.array_equal(_flat(dec.ycbcr_out()), ref[i]), i


def test_packet_decoder_dups_follow_the_jax_decoder():
    """Return codes, granule positions and frames against the JAX host
    Decoder on a stream with dup packets, one of them leading."""
    info, setup, datas = _stream(mk.TC_SOURCE)
    datas = mk.dup_packets(datas)
    pkts = read_tpkt(os.path.join(TESTDATA, mk.TC_SOURCE))
    ref = JaxHostDecoder(jax_info(pkts[0].data), jax_setup(pkts[2].data))
    dec = PacketDecoder(info, setup, device="cpu")
    rets = []
    for data in datas:
        rets.append(dec.decode_packet(data))
        assert rets[-1] == ref.decode_packet(data)
        assert dec.granpos == ref.granpos
        for a, b in zip(dec.ycbcr_out(), ref.ycbcr_out()):
            assert np.array_equal(a, b)
    assert rets.count(1) == datas.count(b"")


def test_batch_and_packet_decode_alternate():
    """decode_batch, decode_packet, decode_clip and decode_packet again on
    one decoder and one set of resident references."""
    info, setup, datas = _stream("cif_k4_q40.tpkt")
    ref = np.fromfile(os.path.join(TESTDATA, "cif_k4_q40.ref.yuv"),
                      np.uint8).reshape(len(datas), -1)
    dec = PacketDecoder(info, setup, device="cpu")
    outs = dec.decode_batch(datas[0:2])
    dec.decode_packet(datas[2])
    outs.append(dec.ycbcr_out())
    outs += dec.decode_clip(datas[3:5], batch=8)
    dec.decode_packet(datas[5])
    outs.append(dec.ycbcr_out())
    assert len(outs) == len(datas)
    for i, o in enumerate(outs):
        assert np.array_equal(_flat(o), ref[i]), i
