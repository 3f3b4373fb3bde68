"""The PyTorch port's rate control against the JAX package: RateControl
(1-pass qi selection, the pass-1 metrics file, its parse, the pass-2
window allocation and twopass_window_qvecs) and WindowRateController on
synthetic bit sequences; GopEncoder(device="cpu") in CBR and 2-pass
against the JAX TpuGopEncoder's packet and metrics-file lists
(testdata/make_hd720_enc.py); and the encoder CLI's speed and rate flags
against the JAX CLI's device branch. Exact equality everywhere."""
import hashlib
import importlib.util
import os

import numpy as np
import pytest
import torch

from tests.conftest import TESTDATA
from theora_tpu.encode import rate as jrate
from theora_tpu.info import TheoraInfo as JaxInfo
from theora_tpu_torch.encode import rate
from theora_tpu_torch.info import TheoraInfo

# The tests run in several worker processes on a few CPUs: one torch
# thread each (their tensors are small, and idle intra-op threads spin).
torch.set_num_threads(1)

_spec = importlib.util.spec_from_file_location(
    "make_hd720_enc", os.path.join(TESTDATA, "make_hd720_enc.py"))
make_enc = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(make_enc)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _infos(w=352, h=288, quality=0, bitrate=300_000):
    kw = dict(frame_width=w, frame_height=h, pic_width=w, pic_height=h,
              quality=quality, target_bitrate=bitrate, fps_numerator=30,
              fps_denominator=1)
    return TheoraInfo(**kw), JaxInfo(**kw)


def _controllers(kf, quality=0, bitrate=300_000):
    pi, ji = _infos(quality=quality, bitrate=bitrate)
    return rate.RateControl(pi, kf), jrate.RateControl(ji, None, kf)


def _bits(rng, n):
    """n synthetic frame sizes in bits, over two orders of magnitude."""
    return (rng.lognormal(9.5, 1.0, n)).astype(np.int64) + 1


def _state(rc):
    return (rc.fullness, rc.rate_bias, rc.log_scale, rc.nencoded,
            rc.inter_delay, rc.log_qtarget)


@pytest.mark.parametrize("quality,kf", [(0, 8), (24, 5)])
def test_one_pass_select_qi_trajectory_equals_jax(quality, kf):
    """select_qi and update frame by frame, without frame dropping as
    the device encoder runs it (with the quality floor where set): the
    same qi trajectory and state."""
    rng = np.random.default_rng(40 + kf)
    ours, ref = _controllers(kf, quality)
    ref.drop_frames = False
    qa = qb = None
    for i, bits in enumerate(_bits(rng, 60)):
        ft = 0 if i % kf == 0 else 1
        qa, qb = ours.select_qi(ft, qa), ref.select_qi(ft, qb)
        assert qa == qb, i
        ours.update(ft, qa, int(bits))
        assert not ref.update(ft, qb, int(bits))
        assert _state(ours) == _state(ref), i


def _pass1(rc, kf, bits, **kw):
    head = rc.start_pass1()
    qi = rc._pass1_qi
    body = b""
    for i, b in enumerate(bits):
        ft = 0 if i % kf == 0 else 1
        qi = rc.select_qi(ft, qi)
        rc.update(ft, qi, int(b), **kw)
        body += rc.pass1_frame_data()
    return head, rc.pass1_summary() + body


@pytest.mark.parametrize("buf_delay", [None, 16])
def test_two_pass_metrics_and_window_qvecs_equal_jax(buf_delay):
    """The pass-1 file (placeholder header, records and summary) byte for
    byte, its parse, and pass 2 from it: per window of two GOPs the qi
    vectors of twopass_window_qvecs, then the replay of each frame with
    synthetic real bits, with the whole file as the window and with a
    16-frame buffer."""
    rng = np.random.default_rng(41)
    kf = 6
    bits = _bits(rng, 40)
    ours, ref = _controllers(kf)
    ref.drop_frames = False
    (ha, blob), (hb, jblob) = (_pass1(ours, kf, bits),
                               _pass1(ref, kf, bits, droppable=False))
    assert ha == hb and blob == jblob
    sa, ma = rate.RateControl.twopass_parse(blob)
    sb, mb = jrate.RateControl.twopass_parse(blob)
    assert sa == sb
    assert [vars(m) for m in ma] == [vars(m) for m in mb]
    ours, ref = _controllers(kf, bitrate=400_000)
    ref.drop_frames = False
    for rc in (ours, ref):
        rc.start_pass2(blob, buf_delay)
    gop_lens = [kf] * (len(bits) // kf) + [len(bits) % kf]
    applied = 40
    seen = set()
    for w0 in range(0, len(gop_lens), 2):
        lens = gop_lens[w0:w0 + 2]
        qa = rate.twopass_window_qvecs(ours, lens, applied)
        qb = jrate.twopass_window_qvecs(ref, lens, applied)
        assert qa == qb
        seen.update(q for qv in qa for q in qv)
        prev = applied
        for qv in qa:
            for j, q in enumerate(qv):
                ft = 0 if j == 0 else 1
                b = int(rng.lognormal(9.0, 0.8))
                for rc, kw in ((ours, {}), (ref, {"droppable": False})):
                    rc.select_qi(ft, prev)
                    rc.log_qtarget = rc.log_qavg[ft][q]
                    rc.update(ft, q, b, **kw)
                prev = q
                assert _state(ours) == _state(ref)
        applied = prev
    assert len(seen) > 1


class _Qi:
    """The part of an encoder the window controller drives."""

    def __init__(self, info, qi):
        self.info = info
        self.qi = qi

    def set_qi(self, qi):
        self.qi = int(np.clip(qi, 0, 63))


def test_window_rate_controller_qi_path_equals_jax():
    """WindowRateController against the JAX one over 30 GOPs of
    synthetic sizes, windows of 1 and 3 GOPs: the same qi after every
    update, and the qi moves both ways."""
    from theora_tpu.encode.tpu_gop import WindowRateController as Jax
    from theora_tpu_torch.encode.gop import WindowRateController

    rng = np.random.default_rng(42)
    pi, ji = _infos(bitrate=90_000)
    for window in (1, 3):
        a, b = _Qi(pi, 40), _Qi(ji, 40)
        ours, ref = WindowRateController(a, 90_000, window), \
            Jax(b, 90_000, window)
        path = []
        for g in range(30):
            bits = int(rng.lognormal(11.5 + (g > 15), 0.6)) * 8
            for rc in (ours, ref):
                rc.add(bits, 8)
                if (g + 1) % window == 0:
                    rc.update()
            assert a.qi == b.qi, (window, g)
            path.append(a.qi)
        assert min(path) < 40 < max(path) or len(set(path)) > 2


# ------------------------------------------------------- whole encodes

def _encoder(qi, quality=None):
    from theora_tpu_torch.encode.gop import GopEncoder

    q = qi if quality is None else quality
    return GopEncoder(TheoraInfo(frame_width=64, frame_height=48,
                                 pic_width=64, pic_height=48, quality=q),
                      qi=qi, device="cpu")


def _want(name):
    with open(os.path.join(TESTDATA, name)) as f:
        return f.read().split()


def _hashes(datas):
    return [hashlib.sha256(d).hexdigest() for d in datas]


def _frame_qis(pkts):
    """The base qi in each data packet's frame header."""
    return [p.data[0] & 0x3F for p in pkts[3:]]


def test_cbr_packets_equal_jax_list():
    """encode_clip with target_bitrate=60_000 and rate_window=1 on the
    noisy 64x48 clip (tests/test_tpu_gop.py's case): every packet equals
    the JAX encoder's, and the qi moved from 40 (the first GOPs filter,
    qi < 47; the later ones do not)."""
    enc = _encoder(make_enc.CBR_QI)
    pkts = enc.encode_clip(make_enc.cbr_frames(),
                           keyframe_freq=make_enc.CBR_KF,
                           target_bitrate=make_enc.CBR_RATE, rate_window=1)
    assert _hashes(p.data for p in pkts) == _want("cbr64x48_enc.sha256")
    assert enc.qi != make_enc.CBR_QI
    qis = _frame_qis(pkts)
    assert min(qis) < 47 <= max(qis)


def test_two_pass_packets_and_metrics_equal_jax_list():
    """encode_clip_twopass at 60 kbit/s with the whole file as the
    window: the packets and the pass-1 metrics blob equal the JAX
    encoder's, and the frames carry more than one qi."""
    enc = _encoder(make_enc.CBR_QI, quality=0)
    pkts, blob = enc.encode_clip_twopass(
        make_enc.cbr_frames(), keyframe_freq=make_enc.CBR_KF,
        target_bitrate=make_enc.CBR_RATE)
    assert _hashes([p.data for p in pkts] + [blob]) == \
        _want("twopass64x48_enc.sha256")
    assert len(set(_frame_qis(pkts))) > 1
    assert enc.qi == make_enc.CBR_QI


@pytest.mark.parametrize("flags", [
    ["-z", "2", "-b", "60000", "--two-pass", "--rate-buffer", "12"],
    ["-z", "4", "-b", "60000"],
])
def test_encoder_cli_speed_and_rate_flags_equal_jax_cli(tmp_path, flags):
    """python -m theora_tpu_torch.tools.enc --device cpu with -z, -b,
    --two-pass, --two-pass-file and --rate-buffer writes the JAX CLI's
    device-tier .ogv and pass-1 file, for 4 frames of the noisy 64x48
    clip at q40 (one GOP: the JAX scans of both passes share one
    compilation)."""
    from theora_tpu.tools import enc as jenc
    from theora_tpu_torch.tools import enc as tenc
    from theora_tpu_torch.tools.y4m import write_y4m

    y4m = str(tmp_path / "in.y4m")
    write_y4m(y4m, make_enc.cbr_frames()[:4])
    common = ["-q", "40", "-k", "4"] + flags
    outs = {}
    for who, main, dev in (("jax", jenc.main, ["--device"]),
                           ("port", tenc.main, ["--device", "cpu"])):
        extra = (["--two-pass-file", str(tmp_path / f"{who}.ot2p")]
                 if "--two-pass" in flags else [])
        main(dev + common + extra + [y4m, str(tmp_path / f"{who}.ogv")])
        outs[who] = [open(tmp_path / f"{who}.{ext}", "rb").read()
                     for ext in ("ogv", "ot2p") if ext == "ogv" or extra]
    assert outs["port"] == outs["jax"]
