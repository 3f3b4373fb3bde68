"""The port's batch decode slice on the CPU against the JAX package and
libtheora's golden output: headers, whole-slice parity with
TpuBatchDecoder, golden streams, chained and dup-bearing batches, and a
stream started in JAX and finished in the port. Exact equality."""
import os
import subprocess
import sys

import numpy as np
import pytest

from tests.conftest import REPO_ROOT, TESTDATA
from theora_tpu.decode.decoder import Decoder as JaxHostDecoder
from theora_tpu.decode.tpu_batch import TpuBatchDecoder
from theora_tpu.headers import parse_info_header as jax_info
from theora_tpu.headers import parse_setup_header as jax_setup
from theora_tpu.quant import dequant_tables_init as jax_dequant
from theora_tpu.tpkt import read_tpkt as jax_read_tpkt
from theora_tpu_torch.decode.batch import BatchDecoder
from theora_tpu_torch.decode.state import load_reference_state
from theora_tpu_torch.headers import parse_comment_header, \
    parse_info_header, parse_setup_header
from theora_tpu_torch.ogg import demux_stream
from theora_tpu_torch.quant import dequant_tables_init
from theora_tpu_torch.tpkt import read_tpkt


def _stream(name):
    pkts = read_tpkt(os.path.join(TESTDATA, f"{name}.tpkt"))
    info = parse_info_header(pkts[0].data)
    setup = parse_setup_header(pkts[2].data)
    return info, setup, [p.data for p in pkts[3:]]


def _golden(name, nframes):
    return np.fromfile(os.path.join(TESTDATA, f"{name}.ref.yuv"),
                       dtype=np.uint8).reshape(nframes, -1)


def _flat(frame):
    return np.concatenate([p.reshape(-1) for p in frame])


def _assert_golden(name, outs):
    ref = _golden(name, len(outs))
    for i, o in enumerate(outs):
        assert np.array_equal(_flat(o), ref[i]), f"{name} frame {i}"


@pytest.mark.parametrize(
    "name", ["cif_k4_q40", "cif_cbr", "clip422", "clip444", "crop80x64",
             "clip64x48_k8_q5"])
def test_headers_match_jax(name):
    jp = jax_read_tpkt(os.path.join(TESTDATA, f"{name}.tpkt"))
    pp = read_tpkt(os.path.join(TESTDATA, f"{name}.tpkt"))
    assert [p.data for p in jp] == [p.data for p in pp]
    ji, pi = jax_info(jp[0].data), parse_info_header(pp[0].data)
    for field in ("frame_width", "frame_height", "pic_width", "pic_height",
                  "pic_x", "pic_y", "fps_numerator", "fps_denominator",
                  "pixel_fmt", "keyframe_granule_shift", "quality"):
        assert getattr(ji, field) == getattr(pi, field), field
    js, ps = jax_setup(jp[2].data), parse_setup_header(pp[2].data)
    assert js.qinfo == ps.qinfo
    assert [b.codes for b in js.codebooks] == [b.codes for b in ps.codebooks]
    assert np.array_equal(jax_dequant(js.qinfo), dequant_tables_init(ps.qinfo))
    assert parse_comment_header(pp[1].data)["vendor"]


def test_whole_slice_matches_jax_batch_decoder():
    name = "clip64x48_k8_q5"
    info, setup, data = _stream(name)
    jp = jax_read_tpkt(os.path.join(TESTDATA, f"{name}.tpkt"))
    jdec = TpuBatchDecoder(jax_info(jp[0].data), jax_setup(jp[2].data))
    ref = jdec.decode_batch(data)
    dec = BatchDecoder(info, setup, device="cpu")
    outs = dec.decode_batch(data)
    assert len(outs) == len(ref) == len(data)
    for i, (a, b) in enumerate(zip(outs, ref)):
        for pa, pb in zip(a, b):
            assert np.array_equal(pa, pb), f"frame {i}"
    _assert_golden(name, outs)
    assert dec.ref_idx == jdec.ref_idx
    prev, gold = dec.reference_planes()
    for pli in range(3):
        jprev, jgold = jdec._dev_refs[pli]
        assert np.array_equal(prev[pli], np.asarray(jprev))
        assert np.array_equal(gold[pli], np.asarray(jgold))


@pytest.mark.parametrize(
    "name", ["cif_k4_q40", "crop80x64", "clip422", "clip444", "cif_cbr"])
def test_golden_streams(name):
    info, setup, data = _stream(name)
    outs = BatchDecoder(info, setup, device="cpu").decode_clip(data, batch=4)
    assert len(outs) == len(data)
    _assert_golden(name, outs)


def test_chained_uneven_batches():
    """Batch boundaries mid-GOP: reference planes carried across calls."""
    name = "cif_k4_q40"
    info, setup, data = _stream(name)
    dec = BatchDecoder(info, setup, device="cpu")
    outs = []
    for lo, hi in ((0, 3), (3, 5), (5, len(data))):
        outs.extend(dec.decode_batch(data[lo:hi]))
    _assert_golden(name, outs)


def test_decode_clip_with_dups_matches_scalar_decoder():
    """A dup that leads a chunk repeats the previous chunk's last frame;
    also a mid-chunk dup and a dup-only chunk (the pattern of
    tests/test_jax_ops.py:248)."""
    name = "cif_k4_q40"
    info, setup, data = _stream(name)
    data = data[:3] + [b""] + data[3:4] + [b""] + [b"", b"", b""] + data[4:]
    jp = jax_read_tpkt(os.path.join(TESTDATA, f"{name}.tpkt"))
    href = JaxHostDecoder(jax_info(jp[0].data), jax_setup(jp[2].data))
    truth = []
    for d in data:
        href.decode_packet(d)
        truth.append(href.ycbcr_out())
    a = BatchDecoder(info, setup, device="cpu").decode_clip(data, batch=3)
    b = []
    dec = BatchDecoder(info, setup, device="cpu")
    for lo in range(0, len(data), 3):
        b.extend(dec.decode_batch(data[lo:lo + 3]))
    assert len(a) == len(b) == len(truth) == len(data)
    for i, (fa, fb, ft) in enumerate(zip(a, b, truth)):
        for pa, pb, pt in zip(fa, fb, ft):
            assert np.array_equal(pa, pt), f"clip frame {i}"
            assert np.array_equal(pb, pt), f"batch frame {i}"


def test_stream_resumed_from_jax_state():
    """First 5 frames in the JAX TpuBatchDecoder, the rest in the port
    after load_reference_state; the whole must equal the golden."""
    name = "cif_k4_q40"
    info, setup, data = _stream(name)
    jp = jax_read_tpkt(os.path.join(TESTDATA, f"{name}.tpkt"))
    jdec = TpuBatchDecoder(jax_info(jp[0].data), jax_setup(jp[2].data))
    head = jdec.decode_batch(data[:5])
    prev = [np.asarray(jdec._dev_refs[pli][0]) for pli in range(3)]
    gold = [np.asarray(jdec._dev_refs[pli][1]) for pli in range(3)]
    dec = BatchDecoder(info, setup, device="cpu")
    load_reference_state(dec, prev, gold, jdec.ref_idx, jdec.keyframe_num,
                         jdec.curframe_num)
    tail = dec.decode_clip(data[5:], batch=8)
    _assert_golden(name, head + tail)
    assert dec.curframe_num == len(data)


def test_load_reference_state_rejects_bad_planes():
    info, setup, _ = _stream("clip64x48_k8_q5")
    dec = BatchDecoder(info, setup, device="cpu")
    bad = [np.zeros((3, 3), np.uint8)] * 3
    with pytest.raises(ValueError):
        load_reference_state(dec, bad, bad, dec.ref_idx, 0, 0)


def test_dec_tool_matches_host_decoder(tmp_path):
    """python -m theora_tpu_torch.tools.dec --device cpu writes the same
    y4m as the JAX package's host decoder tool."""
    src = os.path.join(TESTDATA, "cif_k4_q40.ogv")
    mine, ref = tmp_path / "port.y4m", tmp_path / "host.y4m"
    env = dict(os.environ, PYTHONPATH=REPO_ROOT)
    for mod, out, extra in (("theora_tpu_torch.tools.dec", mine,
                             ["--device", "cpu", "--batch", "3"]),
                            ("theora_tpu.tools.dec", ref, [])):
        subprocess.run([sys.executable, "-m", mod, *extra, src, str(out)],
                       check=True, capture_output=True, env=env, cwd=REPO_ROOT,
                       timeout=120)
    assert mine.read_bytes() == ref.read_bytes()
    with open(src, "rb") as f:
        assert len(demux_stream(f.read())) > 3
