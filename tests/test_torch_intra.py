"""The all-keyframe batch encoder (BatchIntraEncoder, with the keyframe
path of the host Encoder), the pipeline cores, the native keyframe
helpers and the debug wrap checks of the PyTorch port, against the JAX
package on the CPU.

The batch encoder's packets must equal the JAX host Encoder's at
keyframe_freq=1, byte for byte, and JAX's TpuBatchIntraEncoder's wherever
its fault F5 (one qi per batch under rate control) does not apply; the
cores and the native helpers must give JAX's integers exactly."""
import hashlib
import importlib.util
import os

import numpy as np
import pytest
import torch

from tests.conftest import TESTDATA
from theora_tpu_torch.encode.intra import BatchIntraEncoder
from theora_tpu_torch.info import TheoraInfo

# The tests run in several worker processes on a few CPUs: one torch
# thread each (their tensors are small, and idle intra-op threads spin).
torch.set_num_threads(1)

_spec = importlib.util.spec_from_file_location(
    "make_hd720_enc", os.path.join(TESTDATA, "make_hd720_enc.py"))
mk = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(mk)

SMALL_CASES = [c for c in mk.INTRA_CASES if c in mk.INTRA_SMALL + mk.INTRA_AQ]


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _kw(case, target_bitrate=0):
    _, w, h, fmt, qi, _, _ = mk.INTRA_CASES[case]
    return dict(frame_width=w, frame_height=h, pic_width=w, pic_height=h,
                quality=qi, pixel_fmt=fmt, target_bitrate=target_bitrate)


def _setup(enc, case):
    *_, mode, splevel = mk.INTRA_CASES[case]
    enc.adaptive_quant = mode
    if splevel:
        enc.set_splevel(splevel)
    return enc


def _port(case, target_bitrate=0):
    b = BatchIntraEncoder(TheoraInfo(**_kw(case, target_bitrate)),
                          device="cpu")
    _setup(b.enc, case)
    frames = mk.intra_frames(mk.INTRA_CASES[case][0])
    return [p.data for p in b.flush_headers() + b.encode(frames)]


def _jax_host(case, target_bitrate=0):
    from theora_tpu.encode.encoder import Encoder
    from theora_tpu.info import TheoraInfo as JaxInfo

    enc = _setup(Encoder(JaxInfo(**_kw(case, target_bitrate))), case)
    enc.keyframe_freq = 1
    frames = mk.intra_frames(mk.INTRA_CASES[case][0])
    return [p.data for p in enc.flush_headers()] + [
        enc.encode_frame(f).data for f in frames]


def _jax_batch(case, target_bitrate=0):
    from theora_tpu.encode.tpu_encoder import TpuBatchIntraEncoder
    from theora_tpu.info import TheoraInfo as JaxInfo

    b = TpuBatchIntraEncoder(JaxInfo(**_kw(case, target_bitrate)))
    _setup(b.enc, case)
    frames = mk.intra_frames(mk.INTRA_CASES[case][0])
    return [p.data for p in b.flush_headers() + b.encode(frames)]


@pytest.mark.parametrize("case", SMALL_CASES)
def test_batch_intra_equals_jax_host_and_batch(case):
    """q40 and q60 (the intra triple), adaptive_quant False, True and
    "auto" (with per-block lambda scales on the 96x64 mixed clips), speed
    levels 2 and 3, pixel formats 0, 2 and 3."""
    got = _port(case)
    assert got == _jax_host(case)
    assert got == _jax_batch(case)


@pytest.mark.parametrize("name,cases", [
    ("intra64x48_enc.sha256", mk.INTRA_SMALL),
    ("intra96x64_aq_enc.sha256", mk.INTRA_AQ),
])
def test_batch_intra_equals_lists(name, cases):
    """The lists chip_smoke.py holds the card's packets to."""
    with open(os.path.join(TESTDATA, name)) as f:
        want = f.read().split()
    got = [hashlib.sha256(d).hexdigest() for c in cases for d in _port(c)]
    assert got == want


def test_rate_control_follows_the_host_encoder_not_the_jax_batch():
    """F5: with a target bitrate the qi moves frame to frame; the port
    launches each frame at its own qi and equals the host Encoder (and
    the list), while JAX's batch quantizes every frame at the batch's
    first qi and differs."""
    got = _port(mk.F5_CASE, mk.F5_RATE)
    host = _jax_host(mk.F5_CASE, mk.F5_RATE)
    assert got == host
    with open(os.path.join(TESTDATA, "intra64x48_f5_enc.sha256")) as f:
        assert [hashlib.sha256(d).hexdigest() for d in got] == \
            f.read().split()
    qis = {d[0] & 0x3F for d in got[3:]}
    assert len(qis) > 1
    jax_batch = _jax_batch(mk.F5_CASE, mk.F5_RATE)
    assert any(a != b for a, b in zip(jax_batch, host))


def _count_k2(monkeypatch):
    from theora_tpu_torch.ops import fdct_cuda

    calls = []
    real = fdct_cuda.fdct_quantize

    def counted(res, deq, inter):
        calls.append(res.shape[0])
        return real(res, deq, inter)

    monkeypatch.setattr(fdct_cuda, "fdct_quantize", counted)
    return calls


@pytest.mark.parametrize("case,rate,want", [
    ("q40", 0, [6 * 48, 6 * 12, 6 * 12]),
    ("q60", 0, []),
    ("sp2_q40", 0, []),
    ("q40", mk.F5_RATE, None),
])
def test_k2_runs_once_per_plane_per_batch_on_frames_that_use_it(
        monkeypatch, case, rate, want):
    """One K2 call per plane index over every block of the batch's
    single-qi frames; none for frames of the qi triple or at speed 2;
    with a target bitrate one per plane per frame that takes the device
    results."""
    calls = _count_k2(monkeypatch)
    b = BatchIntraEncoder(TheoraInfo(**_kw(case, rate)), device="cpu")
    _setup(b.enc, case)
    frames = mk.intra_frames(mk.INTRA_CASES[case][0])
    pkts = b.encode(frames)
    if want is not None:
        assert calls == want
        return
    single = sum((p.data[1] & 0x80) == 0 for p in pkts)
    assert 0 < single < len(frames)
    assert calls == [48, 12, 12] * single


def test_inter_frame_under_target_bitrate_raises():
    """An inter frame under a target bitrate (the host rate control's
    frame drop is not ported); without one it encodes
    (tests/test_torch_host_inter.py)."""
    from theora_tpu_torch.encode.encoder import Encoder

    enc = Encoder(TheoraInfo(**_kw("q40", mk.F5_RATE)), device="cpu")
    enc.keyframe_freq = 4
    frames = mk.clip64x48_frames(2)
    enc.encode_frame(frames[0])
    with pytest.raises(NotImplementedError, match="target bitrate"):
        enc.encode_frame(frames[1])


def _core_inputs(rng):
    blocks = rng.integers(0, 256, (2, 3, 37, 8, 8), dtype=np.uint8)
    blocks[0, 0, :6] = rng.integers(122, 134, (6, 8, 8))
    dq = rng.integers(4, 90, 64).astype(np.int32)
    n = 41
    cur = rng.integers(0, 256, (n, 8, 8), dtype=np.uint8)
    pred = rng.integers(0, 256, (n, 8, 8), dtype=np.uint8)
    intra = rng.random(n) < 0.3
    dqi = rng.integers(4, 90, 64).astype(np.int32)
    dqe = rng.integers(4, 90, 64).astype(np.int32)
    return (blocks, dq), (cur, pred, intra, dqi, dqe)


def _recon_inputs(rng):
    h, w, n = 64, 80, 30
    planes = [rng.integers(0, 256, (h, w), dtype=np.uint8)
              for _ in range(3)]
    pos = rng.choice((h // 8 - 2) * (w // 8 - 2), n, replace=False)
    by = ((pos // (w // 8 - 2) + 1) * 8).astype(np.int32)
    bx = ((pos % (w // 8 - 2) + 1) * 8).astype(np.int32)
    coeffs = rng.integers(-40, 41, (n, 64)).astype(np.int32)
    coeffs[:8, 1:] = 0
    rows = rng.integers(4, 60, (3, 64)).astype(np.int32)
    deq = rows[rng.integers(0, 3, n)]
    dc = rng.integers(-300, 300, n).astype(np.int32)
    dc_only = (coeffs[:, 1:] == 0).all(axis=1)
    refsel = rng.integers(0, 3, n).astype(np.int32)
    offs = [rng.integers(-8, 9, n).astype(np.int32) for _ in range(4)]
    use2 = rng.random(n) < 0.5
    return (*planes, by, bx, coeffs, deq, dc, deq[:, 0].copy(), dc_only,
            refsel, *offs, use2)


@pytest.mark.parametrize("core", ["intra_encode_core", "inter_encode_core",
                                  "recon_core"])
def test_pipeline_cores_equal_jax(core):
    """The three cores on seeded inputs (intra with two leading batch
    dims and DC-only blocks; recon with the three reference kinds, one
    and two references, three distinct dequant rows): JAX's integers."""
    import jax.numpy as jnp

    from theora_tpu import pipeline as jp
    from theora_tpu_torch import pipeline as tp

    rng = np.random.default_rng(20261017)
    intra, inter = _core_inputs(rng)
    args = {"intra_encode_core": intra, "inter_encode_core": inter,
            "recon_core": _recon_inputs(rng)}[core]
    want = getattr(jp, core)(*map(jnp.asarray, args))
    got = getattr(tp, core)(*map(torch.from_numpy, args))
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for g, w in zip(got, want):
        assert g.dtype == {np.dtype(np.int32): torch.int32,
                           np.dtype(np.uint8): torch.uint8}[np.asarray(w)
                                                             .dtype]
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _plan_rows(paths):
    """Each block's plan up to its end (a terminal EOB row or a row
    with zzi < 0); the rows after it are never read."""
    out = paths.copy()
    for i in range(len(out)):
        for r in range(66):
            if out[i, r, 0] < 0 or out[i, r, 1] < 7:
                out[i, r + (out[i, r, 0] >= 0):] = 0
                break
    return out


def test_native_keyframe_helpers_equal_jax():
    """fdct_quantize_rd_native (plain and R/D) and
    trellis_plan_blocks_native (one lambda, and one per block) on 2,000
    seeded blocks."""
    import theora_tpu.native as jn

    import theora_tpu_torch.native as tn

    rng = np.random.default_rng(11)
    res = rng.integers(-128, 128, (2000, 8, 8)).astype(np.int32)
    res[:600] //= 16
    dq0 = rng.integers(4, 60, 64).astype(np.int32)
    dq1 = rng.integers(4, 60, 64).astype(np.int32)
    for rd in (False, True):
        want = jn.fdct_quantize_rd_native(res, dq0, 123.4, rd=rd,
                                          want_dct=True)
        got = tn.fdct_quantize_rd_native(res, dq0, 123.4, rd=rd,
                                         want_dct=True)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    qz, _, _, dct = want
    qti = (rng.random(2000) < 0.3).astype(np.int32)
    nbt = rng.integers(1, 20, (5, 32)).astype(np.int64)
    for lam in (77.9, rng.random(2000) * 200):
        qj, qt = qz.copy(), qz.copy()
        want = jn.trellis_plan_blocks_native(dct, qj, dq0, dq1, qti, lam,
                                             nbt)
        got = tn.trellis_plan_blocks_native(dct, qt, dq0, dq1, qti, lam,
                                            nbt)
        np.testing.assert_array_equal(qt, qj)
        np.testing.assert_array_equal(_plan_rows(got[0]),
                                      _plan_rows(want[0]))
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])


def test_i16_wrap_check_fires_on_overflow(monkeypatch):
    """With the debug flag armed, an int16 wrap that changes a value
    raises OverflowError; legal values pass untouched."""
    from theora_tpu_torch.ops import transforms

    monkeypatch.setattr(transforms, "_DBG", True)
    monkeypatch.setattr("theora_tpu_torch.debug.DEBUG", True)
    ok = transforms._i16(torch.tensor([100, -32768, 32767],
                                      dtype=torch.int32))
    assert ok.tolist() == [100, -32768, 32767]
    with pytest.raises(OverflowError, match="int16 overflow"):
        transforms._i16(torch.tensor([40000], dtype=torch.int32))


def test_i16_wrap_check_off_by_default():
    """Without the env flag the wrap stays silent wraparound (the spec
    semantics)."""
    if os.environ.get("THEORA_TPU_DEBUG", "") not in ("", "0"):
        pytest.skip("suite running with debug armed")
    from theora_tpu_torch.ops import transforms

    v = transforms._i16(torch.tensor([40000], dtype=torch.int32))
    assert int(v[0]) == 40000 - 65536


def test_trace_writes_a_chrome_trace_with_named_scopes(tmp_path):
    from theora_tpu_torch import debug, pipeline

    blocks = torch.full((1, 4, 8, 8), 130, dtype=torch.uint8)
    with debug.trace(str(tmp_path)):
        with debug.named_scope("intra_core"):
            pipeline.intra_encode_core(blocks, torch.full((64,), 8))
    with open(tmp_path / "trace.json") as f:
        assert "intra_core" in f.read()
