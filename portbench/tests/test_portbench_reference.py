"""The reference decoder against libtheora's own output, its controls
against the exact path, and the seeded clips."""
import os
import struct

import numpy as np
import pytest

from conftest import ROOT
from reference.decoder import BadPacket, RefDecoder, idct8x8, idct8x8_float
from synth import Clip

GOLDENS = ["clip64x48_k8_q48", "clip64x48_k1_q48", "clip64x48_k8_q20",
           "clip64x48_k8_q5", "cif_k4_q40", "cif_cbr"]


def _tpkt(path):
    """The packets of a .tpkt file (the repository's test container: the
    magic b"TPKT", then per packet a u32le length, a flags byte, the
    i64le granule position and packet number, and the data)."""
    with open(path, "rb") as f:
        raw = f.read()
    assert raw[:4] == b"TPKT"
    off, out = 4, []
    while off < len(raw):
        (n,) = struct.unpack_from("<I", raw, off)
        off += 4 + 1 + 16
        out.append(raw[off:off + n])
        off += n
    return out


@pytest.mark.parametrize("name", GOLDENS)
def test_reference_equals_libtheora(name):
    pk = _tpkt(os.path.join(ROOT, "testdata", name + ".tpkt"))
    ref = np.fromfile(os.path.join(ROOT, "testdata", name + ".ref.yuv"),
                      np.uint8)
    dec = RefDecoder(pk[:3])
    w, h = dec.info.pic_width, dec.info.pic_height
    assert (w, h) == (dec.info.frame_width, dec.info.frame_height)
    fsz = w * h * 3 // 2
    assert len(ref) // fsz > 0
    for k in range(len(ref) // fsz):
        got = np.concatenate([p.ravel() for p in dec.decode(pk[3 + k])])
        assert np.array_equal(got, ref[k * fsz:(k + 1) * fsz]), k
    assert dec.bad_packets == 0


def test_a_truncated_packet_is_bad():
    pk = _tpkt(os.path.join(ROOT, "testdata", "clip64x48_k8_q48.tpkt"))
    dec = RefDecoder(pk[:3])
    with pytest.raises(BadPacket):
        dec.decode(pk[3][:len(pk[3]) // 2])
    assert dec.bad_packets == 1


def test_float_idct_control_rounds_differently():
    rng = np.random.default_rng(1)
    coeffs = rng.integers(-300, 300, size=(2000, 8, 8))
    exact, low = idct8x8(coeffs), idct8x8_float(coeffs)
    assert np.abs(exact - low).max() <= 2
    assert (exact != low).any()


def test_clips_repeat_from_their_seed_and_differ_between_seeds():
    a, b = Clip(64, 48, 2**31 + 3), Clip(64, 48, 2**31 + 3)
    c = Clip(64, 48, 7)
    for t in (0, 5):
        assert all(np.array_equal(x, y) for x, y in zip(a.frame(t),
                                                        b.frame(t)))
    assert not np.array_equal(a.frame(0)[0], c.frame(0)[0])
    y, u, v = Clip(1280, 720, 1).frame(3)
    assert y.shape == (720, 1280) and u.shape == v.shape == (360, 640)
