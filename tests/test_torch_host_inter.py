"""The host Encoder's inter path of the PyTorch port, its closed loop
decoded by the port's PacketDecoder, against the JAX host Encoder on the
CPU.

Every case of testdata/make_hd720_enc.py HOST_CASES (64x48 and 96x64) must
give the JAX Encoder's packets byte for byte (data, granulepos, e_o_s),
and after every frame the port's references, UMV borders included, must
equal the JAX embedded decoder's. Tolerance: none, every comparison is
exact."""
import hashlib
import importlib.util
import os

import numpy as np
import pytest
import torch

from tests.conftest import TESTDATA
from theora_tpu_torch.bitio import BitReader
from theora_tpu_torch.encode.encoder import Encoder
from theora_tpu_torch.info import TheoraInfo

_spec = importlib.util.spec_from_file_location(
    "make_hd720_enc", os.path.join(TESTDATA, "make_hd720_enc.py"))
mk = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(mk)

CASES = list(mk.HOST_SMALL + mk.HOST_AQ)
H_CHROMA, W_CHROMA = 24, 32


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _kw(case):
    _, w, h, fmt, qi, *_ = mk.HOST_CASES[case]
    return dict(frame_width=w, frame_height=h, pic_width=w, pic_height=h,
                quality=qi, pixel_fmt=fmt)


def _setup(enc, case):
    *_, mode, splevel, kf = mk.HOST_CASES[case]
    enc.keyframe_freq = kf
    enc.adaptive_quant = mode
    if splevel:
        enc.set_splevel(splevel)
    return enc


def _frames(case):
    return mk.host_frames(mk.HOST_CASES[case][0])


def _port(case):
    enc = _setup(Encoder(TheoraInfo(**_kw(case)), device="cpu"), case)
    frames = _frames(case)
    return enc.flush_headers() + [
        enc.encode_frame(f, e_o_s=i == len(frames) - 1)
        for i, f in enumerate(frames)]


def _jax_encoder(case):
    from theora_tpu.encode.encoder import Encoder as JaxEncoder
    from theora_tpu.info import TheoraInfo as JaxInfo

    return _setup(JaxEncoder(JaxInfo(**_kw(case))), case)


def _frame_qis(data: bytes) -> list:
    """The qi list of a data packet's frame header."""
    br = BitReader(data)
    br.read(2)
    qis = [br.read(6)]
    while len(qis) < 3 and br.read(1):
        qis.append(br.read(6))
    return qis


def _is_key(data: bytes) -> bool:
    return len(data) > 0 and not data[0] & 0x40


def _listed(case):
    """The hashes of `case`'s packets in the committed list chip_smoke.py
    holds the card's packets to (the cases' packets back to back)."""
    name, cases = (("host64x48_enc.sha256", mk.HOST_SMALL)
                   if case in mk.HOST_SMALL
                   else ("host96x64_aq_enc.sha256", mk.HOST_AQ))
    with open(os.path.join(TESTDATA, name)) as f:
        hashes = f.read().split()
    counts = [3 + len(_frames(c)) for c in cases]
    assert sum(counts) == len(hashes)
    start = sum(counts[:cases.index(case)])
    return hashes[start:start + counts[cases.index(case)]]


@pytest.mark.parametrize("case", CASES)
def test_host_encoder_equals_jax(case):
    """q40 (the loop filter in the closed loop), q48, q60 (the inter qi
    triple), adaptive_quant True and False, speed levels 1-4, pixel
    formats 2 and 3 (chroma vectors by format), the scene cuts with the
    auto-keyframe retry, and the 96x64 clips "auto" (per-block lambda
    scales on inter frames): packet by packet (data, granulepos, e_o_s,
    packetno) against the JAX Encoder and the committed list. After every
    frame the padded references the inter path reads (enc_residuals and
    the uncoded SSD at plane_padding offsets), PREV and GOLD, equal the
    JAX Encoder's embedded decoder's, borders included."""
    from theora_tpu.constants import FRAME_GOLD, FRAME_PREV

    jenc = _jax_encoder(case)
    penc = _setup(Encoder(TheoraInfo(**_kw(case)), device="cpu"), case)
    frames = _frames(case)
    want, got = jenc.flush_headers(), penc.flush_headers()
    for i, f in enumerate(frames):
        e_o_s = i == len(frames) - 1
        want.append(jenc.encode_frame(f, e_o_s=e_o_s))
        got.append(penc.encode_frame(f, e_o_s=e_o_s))
        assert got[-1].data == want[-1].data, i
        prev, gold = penc._references()
        dec = jenc._dec
        for pli in range(3):
            want_p = dec.buffers[dec.ref_idx[FRAME_PREV]].planes[pli]
            want_g = dec.buffers[dec.ref_idx[FRAME_GOLD]].planes[pli]
            assert prev[pli].shape == want_p.shape
            assert np.array_equal(prev[pli], want_p), (i, pli)
            assert np.array_equal(gold[pli], want_g), (i, pli)
    assert [(p.data, p.granulepos, p.e_o_s, p.packetno) for p in got] == \
        [(p.data, p.granulepos, p.e_o_s, p.packetno) for p in want]
    assert [hashlib.sha256(p.data).hexdigest() for p in got] == \
        _listed(case)


def test_cases_reach_what_they_name():
    """q60 "auto" engages the three-qi triple on an inter frame; speed 4
    and the scene cuts fire the auto-keyframe retry (a keyframe off the
    forced positions); q40 filters (qi < 47)."""
    q60 = _port("q60")[3:]
    assert any(not _is_key(p.data) and len(_frame_qis(p.data)) == 3
               for p in q60)
    for case in ("sp4_q40", "cut_q40"):
        kf = mk.HOST_CASES[case][-1]
        pkts = _port(case)[3:]
        assert any(_is_key(p.data) for i, p in enumerate(pkts)
                   if i % kf), case
    assert all(_frame_qis(p.data)[0] == 40 for p in _port("q40")[3:])


def test_closed_loop_decodes_each_final_packet_once(monkeypatch):
    """The decoder runs lazily: before an inter frame it decodes the final
    packets since its last decode, skipping any before a keyframe, so
    at a keyframe every 4 over 8 frames it decodes frames 0-2 and 4-6,
    one K1 decode-entry call per plane each."""
    from theora_tpu_torch.ops import idct_cuda

    calls = []
    real = idct_cuda.dequantize_idct_frames

    def counted(*a):
        calls.append(a[0].shape[0])
        return real(*a)

    monkeypatch.setattr(idct_cuda, "dequantize_idct_frames", counted)
    enc = _setup(Encoder(TheoraInfo(**_kw("q40")), device="cpu"), "q40")
    for f in _frames("q40"):
        enc.encode_frame(f)
    assert len(calls) == 6 * 3
    assert enc._undecoded and len(enc._undecoded) == 1


def test_encoder_without_card_raises():
    """The default device is the card; without one construction raises
    and nothing carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Encoder(TheoraInfo(**_kw("q40")))


def test_all_keyframe_batch_builds_no_decoder():
    """BatchIntraEncoder (keyframe_freq 1) never reads the references back,
    so its host Encoder builds no decoder."""
    from theora_tpu_torch.encode.intra import BatchIntraEncoder

    b = BatchIntraEncoder(TheoraInfo(**_kw("q40")), device="cpu")
    b.encode(_frames("q40")[:3])
    assert b.enc._dec is None and b.enc.device.type == "cpu"


@pytest.mark.parametrize("flags", [["-z", "2"], ["--adaptive-quant", "off"],
                                   ["-b", "60000"]])
def test_enc_cli_workers_refuse_other_settings(tmp_path, flags):
    """-j runs the host Encoder at its defaults; JAX's -j drops -z and
    --adaptive-quant silently (a fault not copied): a usage error here."""
    from theora_tpu_torch.tools import enc

    with pytest.raises(SystemExit) as e:
        enc.main(["-j", "2", *flags, "--device", "cpu",
                  str(tmp_path / "in.y4m"), str(tmp_path / "out.ogv")])
    assert e.value.code == 2


def test_f6_empty_plane_of_a_multi_qi_frame():
    """F6: at speed 1 with the qi triple, flat static chroma is skipped
    before the transform; the JAX Encoder then cannot pack the frame
    (ValueError), the port gives the empty planes empty plans. Its
    packets decode, and the luma stays within the q48 coding error of
    the source."""
    from theora_tpu.encode.encoder import Encoder as JaxEncoder
    from theora_tpu.info import TheoraInfo as JaxInfo
    from theora_tpu_torch.decode.scalar import PacketDecoder
    from theora_tpu_torch.headers import parse_info_header, \
        parse_setup_header

    flat = np.full((H_CHROMA, W_CHROMA), 128, np.uint8)
    frames = [[f[0], flat, flat] for f in mk.clip64x48_frames(3)]
    kw = dict(frame_width=64, frame_height=48, pic_width=64, pic_height=48,
              quality=48)
    jenc = JaxEncoder(JaxInfo(**kw))
    penc = Encoder(TheoraInfo(**kw), device="cpu")
    for enc in (jenc, penc):
        enc.keyframe_freq = 8
        enc.adaptive_quant = True
        enc.set_splevel(1)
    jenc.encode_frame(frames[0])
    with pytest.raises(ValueError):
        jenc.encode_frame(frames[1])
    pkts = penc.flush_headers() + [penc.encode_frame(f) for f in frames]
    assert all(len(_frame_qis(p.data)) == 3 for p in pkts[3:])
    dec = PacketDecoder(parse_info_header(pkts[0].data),
                        parse_setup_header(pkts[2].data), device="cpu")
    for p, f in zip(pkts[3:], frames):
        dec.decode_packet(p.data)
        y, u, v = dec.ycbcr_out()
        assert np.array_equal(u, flat) and np.array_equal(v, flat)
        d = y.astype(np.int64) - f[0]
        assert 10 * np.log10(255.0 ** 2 / np.mean(d * d)) > 35
