"""The port's postprocessor (ops/postproc.py, kernel KP's CPU path and
oracle) and the decoders' pp levels against the JAX package on the CPU.

The plain postprocess_plane equals JAX's numpy postproc_np.postprocess_plane
exactly on seeded random planes (dering on and off, strong and weak, luma
and chroma, one-row and one-column planes, variances on each dering
threshold and one either side of it). PacketDecoder(device="cpu") and
BatchDecoder(device="cpu").decode_clip at pp levels 1-7 equal JAX's host
Decoder at the same level frame for frame (and libtheora's pp2 / pp7
goldens), across batch sizes, alternating batch and packet calls, dups
after a postprocessed frame and level switches; a switch to level 0
decodes without pp (fault F9 of the JAX decoder, which keeps returning
its last postprocessed frame).
"""
import os

import numpy as np
import pytest
import torch

from tests.conftest import TESTDATA
from theora_tpu.decode.decoder import Decoder as JaxDecoder
from theora_tpu.headers import parse_info_header as jax_info
from theora_tpu.headers import parse_setup_header as jax_setup
from theora_tpu.ops import postproc_np
from theora_tpu.tpkt import read_tpkt
from theora_tpu_torch import quant
from theora_tpu_torch.decode.batch import BatchDecoder
from theora_tpu_torch.decode.scalar import PacketDecoder
from theora_tpu_torch.headers import parse_info_header, parse_setup_header
from theora_tpu_torch.ops import postproc
from theora_tpu_torch.tools import bench_pp

STREAMS = ("clip64x48_k8_q5", "clip422", "clip444")


def _frame_bytes(frame) -> bytes:
    return b"".join(np.ascontiguousarray(p).tobytes() for p in frame)


@pytest.fixture(scope="module")
def streams():
    """{name: (info, setup, data packets, jax headers)} of the goldens."""
    out = {}
    for name in STREAMS:
        pkts = read_tpkt(os.path.join(TESTDATA, f"{name}.tpkt"))
        out[name] = (parse_info_header(pkts[0].data),
                     parse_setup_header(pkts[2].data),
                     [p.data for p in pkts[3:]],
                     (jax_info(pkts[0].data), jax_setup(pkts[2].data)))
    return out


def _jax_decode(stream, datas, schedule, clear_at_zero=False):
    """JAX's host Decoder over datas, set_pplevel(schedule[i]) before
    packet i; returns the frame bytes per packet. clear_at_zero does at a
    switch to level 0 what JAX's own level-0 branch intends (it is never
    reached there): the DC-qi tracking and the pp planes cleared."""
    dec = JaxDecoder(*stream[3])
    out = []
    level = None
    for i, d in enumerate(datas):
        if schedule[i] != level:
            level = schedule[i]
            dec.set_pplevel(level)
            if clear_at_zero and level == 0:
                dec._pp_dc_qis = None
                dec._pp_planes = None
        dec.decode_packet(d)
        out.append(_frame_bytes(dec.ycbcr_out()))
    return out


@pytest.fixture(scope="module")
def jax_frames(streams):
    """One JAX decode per stream and level, shared by the tests."""
    cache = {}

    def get(name, level):
        if (name, level) not in cache:
            datas = streams[name][2]
            cache[name, level] = _jax_decode(streams[name], datas,
                                             [level] * len(datas))
        return cache[name, level]
    return get


# ------------------------------------------------------- the plain version

def _np_case(seed: int):
    rng = np.random.default_rng(seed)
    nv, nh = [(1, 7), (6, 1), (1, 1), (5, 8), (4, 6), (3, 9)][seed % 6]
    kind = seed % 3
    h, w = 8 * nv, 8 * nh
    if kind == 0:
        src = rng.integers(0, 256, (h, w))
    elif kind == 1:
        src = rng.integers(0, 40, (h, w)) + rng.integers(0, 200)
    else:
        src = (np.repeat(np.repeat(rng.integers(0, 256, (nv, nh)), 8, 0), 8, 1)
               + rng.integers(-6, 7, (h, w))).clip(0, 255)
    dcq = rng.integers(0, 64, (nv, nh)).astype(np.uint8)
    qi = rng.integers(0, 64, (nv, nh)).astype(np.uint8)
    scale = rng.integers(0, 300, 64).astype(np.int32)
    sharp = -rng.integers(0, 80, 64).astype(np.int32)
    return src.astype(np.uint8), dcq, qi, scale, sharp


def _both(src, dcq, qi, scale, sharp, dering, strong, pli):
    want = postproc_np.postprocess_plane(src, dcq, qi, scale, sharp,
                                         dering=dering, strong=strong,
                                         pli=pli)
    t = torch.from_numpy
    got = postproc.postprocess_plane(t(src), t(dcq), t(qi), t(scale),
                                     t(sharp), dering, strong, pli)
    return want, got.numpy()


@pytest.mark.parametrize("seed", range(12))
@pytest.mark.parametrize("dering,strong,pli", [
    (False, False, 0), (True, False, 0), (True, True, 0),
    (False, False, 1), (True, False, 2), (True, True, 1)])
def test_plain_postprocess_equals_jax(seed, dering, strong, pli):
    want, got = _both(*_np_case(seed), dering, strong, pli)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("nv,nh", [(1, 24), (5, 9)])
@pytest.mark.parametrize("strong,pli", [(False, 0), (True, 0), (True, 1)])
def test_plain_postprocess_at_the_dering_thresholds(nv, nh, strong, pli):
    """Variances on each of T1-T4 and one (a one-row plane) or eight
    either side of it (no boundary filters at DC scale 0), so that the
    strict comparisons decide which blocks ring and how often."""
    rng = np.random.default_rng(nv * 100 + nh + 7 * strong + pli)
    targets = bench_pp._threshold_targets(rng, nv, nh)
    src = bench_pp.threshold_plane(targets)
    zero = torch.zeros((nv, nh), dtype=torch.uint8)
    scale = np.concatenate([[0], rng.integers(1, 400, 63)]).astype(np.int32)
    _, var = postproc.deblock_plane(torch.from_numpy(src), zero,
                                    torch.from_numpy(scale))
    assert np.array_equal(var.numpy(), targets)
    step = 1 if nv == 1 else 8
    assert {t + d for t in bench_pp.THRESHOLDS for d in (-step, 0, step)
            } & set(targets.ravel().tolist())
    qi = rng.integers(1, 64, (nv, nh)).astype(np.uint8)
    sharp = -rng.integers(0, 800, 64).astype(np.int32)
    want, got = _both(src, np.zeros((nv, nh), np.uint8), qi, scale, sharp,
                      True, strong, pli)
    assert np.array_equal(got, want)


def test_dering_plan_and_waves():
    """The plain version's block plan and waves: a ringed luma block
    takes 3 passes when strong, its wave is one more than its filtered
    north or west neighbour's; the critical path weighs passes x 15."""
    var = torch.tensor([[4000, 0, 400], [2000, 1600, 0]], dtype=torch.int32)
    npass, strong = postproc.dering_plan(var, True, 0)
    assert npass.tolist() == [[1, 0, 1], [3, 1, 0]]
    assert strong.tolist() == [[True, False, False], [True, True, False]]
    npass, strong = postproc.dering_plan(var, False, 0)
    assert npass.tolist() == [[1, 0, 1], [1, 1, 0]]
    assert strong.tolist() == [[True, False, False], [True, True, False]]
    npass, _ = postproc.dering_plan(var, True, 1)
    assert npass.tolist() == [[3, 0, 1], [1, 1, 0]]
    waves = postproc.dering_waves(np.array([[1, 0, 1], [3, 1, 0]]))
    assert waves.tolist() == [[0, -1, 0], [1, 2, -1]]
    assert bench_pp.critical_path(np.array([[1, 0, 1], [3, 1, 0]])) == 75


def _chain_scalar(npass: np.ndarray) -> int:
    """dependency_steps restated block by block in raster order, pixel by
    pixel in raster order."""
    nv, nh = npass.shape
    final = np.zeros((8 * nv, 8 * nh), np.int64)
    for by in range(nv):
        for bx in range(nh):
            prev = np.zeros((8, 8), np.int64)
            for p in range(1, int(npass[by, bx]) + 1):
                def g(r, c):  # pass p - 1's 10x10 grid (its borders)
                    if 1 <= r <= 8 and 1 <= c <= 8:
                        return prev[r - 1, c - 1]
                    if r == 0:
                        return (final[8 * by - 1, 8 * bx + c - 1] if by
                                else prev[0, c - 1] if p > 1 else 0)
                    if r == 9:
                        return prev[7, c - 1] if by == nv - 1 and p > 1 else 0
                    if c == 0:
                        return (final[8 * by + r - 1, 8 * bx - 1] if bx
                                else prev[r - 1, 0] if p > 1 else 0)
                    return prev[r - 1, 7] if bx == nh - 1 and p > 1 else 0

                t = np.zeros((8, 8), np.int64)
                for y in range(8):
                    for x in range(8):
                        n = t[y - 1, x] if y else g(0, x + 1)
                        w = t[y, x - 1] if x else g(y + 1, 0)
                        t[y, x] = 1 + max(n, w, g(y + 1, x + 1), g(y, x + 1),
                                          g(y + 2, x + 1), g(y + 1, x),
                                          g(y + 1, x + 2))
                prev = t
            final[8 * by:8 * by + 8, 8 * bx:8 * bx + 8] = prev
    return int(final.max())


@pytest.mark.parametrize("shape", [(1, 1), (1, 7), (6, 1), (5, 6), (9, 4)])
def test_dering_dependency_chain(shape):
    """The dering's dependency chain (KP's bound): an isolated interior
    block takes 15 updates in one pass, 19 in three (a pass lags the one
    before by two anti-diagonals), and a filtered neighbour adds 8; on
    random plans it equals the scalar restatement and stays within the
    kernel's block-order path."""
    z = np.zeros((3, 4), np.int64)
    for cells, want in (({}, 0), ({(1, 1): 1}, 15), ({(1, 1): 3}, 19),
                        ({(1, 1): 1, (1, 2): 1}, 23),
                        ({(1, 1): 1, (2, 1): 1}, 23)):
        plan = z.copy()
        for k, v in cells.items():
            plan[k] = v
        assert bench_pp.dependency_steps(plan) == want, cells
    rng = np.random.default_rng(sum(shape))
    for _ in range(3):
        plan = rng.choice([0, 1, 3], shape)
        got = bench_pp.dependency_steps(plan)
        assert got == _chain_scalar(plan)
        assert got <= bench_pp.critical_path(plan)


def test_kp_bound_counts_the_calls_own_bytes():
    """KP's bound counts src read and out written once, the qi grids and
    tables, nothing passed between its launches (those are listed per
    launch), and takes the longer of bytes and dependency chain."""
    h, w, nb = 720, 1280, 90 * 160
    assert bench_pp.call_bytes(h, w, True) == 2 * h * w + 2 * nb + 512
    assert bench_pp.call_bytes(h, w, False) == 2 * h * w + nb + 256
    assert bench_pp.kp_bytes(h, w, True) == [3 * h * w + 5 * nb + 256,
                                             2 * h * w + 5 * nb + 512]
    b = bench_pp.kp_bound(h, w, True)
    assert b["bytes"] == 1_872_512 and b["bound_by"] == "bytes"
    assert b["bound_ms"] == pytest.approx(1_872_512 / 3.35e12 * 1e3)
    b = bench_pp.kp_bound(h, w, True, 3000, 10.0)
    assert b["chain_ms"] == pytest.approx(0.03)
    assert b["bound_ms"] == b["chain_ms"] and b["bound_by"] == "operations"


def test_pp_tables_equal_jax(streams):
    """pp_dc_scale and pp_sharp_mod equal the JAX decoder's, for every
    golden's setup and the default quant parameters."""
    from theora_tpu import tables as jax_tables
    from theora_tpu.quant import pp_dc_scale_init as jax_dc_scale
    from theora_tpu_torch import tables

    for name, st in streams.items():
        jd = JaxDecoder(*st[3])
        assert np.array_equal(quant.pp_dc_scale_init(st[1].qinfo),
                              jd._pp_dc_scale), name
        assert np.array_equal(
            quant.pp_sharp_mod(quant.dequant_tables_init(st[1].qinfo)),
            jd._pp_sharp_mod), name
    assert np.array_equal(quant.pp_dc_scale_init(tables.DEF_QUANT_INFO),
                          jax_dc_scale(jax_tables.DEF_QUANT_INFO))


# ----------------------------------------------------------- the decoders

@pytest.mark.parametrize("name", STREAMS)
@pytest.mark.parametrize("level", range(1, 8))
def test_packet_decoder_at_each_level_equals_jax(streams, jax_frames, name,
                                                 level):
    info, setup, datas, _ = streams[name]
    dec = PacketDecoder(info, setup, device="cpu")
    dec.set_pplevel(level)
    got = []
    for d in datas:
        dec.decode_packet(d)
        got.append(_frame_bytes(dec.ycbcr_out()))
    assert got == jax_frames(name, level)


@pytest.mark.parametrize("name", STREAMS)
@pytest.mark.parametrize("level", range(1, 8))
def test_decode_clip_at_each_level_equals_jax(streams, jax_frames, name,
                                              level):
    info, setup, datas, _ = streams[name]
    dec = BatchDecoder(info, setup, device="cpu")
    dec.set_pplevel(level)
    batch = (1, 3, 8)[level % 3]
    got = [_frame_bytes(f) for f in dec.decode_clip(datas, batch=batch)]
    assert got == jax_frames(name, level)


@pytest.mark.parametrize("level", [2, 7])
def test_decoders_equal_libtheora_pp_goldens(streams, level):
    info, setup, datas, _ = streams["clip64x48_k8_q5"]
    ref = np.fromfile(os.path.join(TESTDATA, f"clip64x48_k8_q5.pp{level}.yuv"),
                      np.uint8).reshape(len(datas), -1)
    want = [r.tobytes() for r in ref]
    bd = BatchDecoder(info, setup, device="cpu")
    bd.set_pplevel(level)
    assert [_frame_bytes(f) for f in bd.decode_clip(datas, batch=8)] == want
    pd = PacketDecoder(info, setup, device="cpu")
    pd.set_pplevel(level)
    got = []
    for d in datas:
        pd.decode_packet(d)
        got.append(_frame_bytes(pd.ycbcr_out()))
    assert got == want


@pytest.mark.parametrize("name", ["clip64x48_k8_q5", "clip422"])
def test_alternating_batch_and_packet_calls_with_dups(streams, name):
    """Batch and packet calls alternate on one stream at level 7, with a
    dup packet after a postprocessed frame at the head of a batch, inside
    a batch and between packets: the pp state (DC qis, the persistent qii
    and qi slots) carries over and every output equals JAX's."""
    info, setup, datas, _ = streams[name]
    seq = datas[:2] + [b""] + datas[2:4] + [b"", b""] + datas[4:]
    want = _jax_decode(streams[name], seq, [7] * len(seq))
    dec = PacketDecoder(info, setup, device="cpu")
    dec.set_pplevel(7)
    got = [_frame_bytes(f) for f in dec.decode_batch(seq[:2])]
    got += [_frame_bytes(f) for f in dec.decode_batch(seq[2:4])]
    for d in seq[4:6]:
        assert dec.decode_packet(d) == (1 if not d else 0)
        got.append(_frame_bytes(dec.ycbcr_out()))
    got += [_frame_bytes(f) for f in dec.decode_clip(seq[6:8], batch=1)]
    dec.decode_packet(seq[8])
    got.append(_frame_bytes(dec.ycbcr_out()))
    got += [_frame_bytes(f) for f in dec.decode_clip(seq[9:], batch=3)]
    assert len(got) == len(seq)
    assert got == want


def _port_schedule(stream, datas, schedule, batch=None):
    info, setup = stream[0], stream[1]
    dec = PacketDecoder(info, setup, device="cpu")
    out = []
    level = None
    for i, d in enumerate(datas):
        if schedule[i] != level:
            level = schedule[i]
            dec.set_pplevel(level)
        if batch and i % 2:
            out += [_frame_bytes(f) for f in dec.decode_batch([d])]
            continue
        dec.decode_packet(d)
        out.append(_frame_bytes(dec.ycbcr_out()))
    return out


@pytest.mark.parametrize("schedule", [
    [7, 7, 7, 1, 1, 1, 1, 1],
    [7, 7, 1, 1, 1, 7, 7, 7],
    [7, 7, 7, 0, 0, 7, 7, 7],
])
@pytest.mark.parametrize("batch", [False, True])
def test_level_switches_equal_jax(streams, schedule, batch):
    """7 -> 1 and 7 -> 1 -> 7 against JAX's decoder through the same
    schedule; 7 -> 0 -> 7 against JAX's decoder with its level-0 branch's
    clearing done at the switch (the tracking restarts at the next
    keyframe: clip64x48_k8_q5's frames 3-7 are inter frames, so they
    decode without pp)."""
    st = streams["clip64x48_k8_q5"]
    datas = st[2]
    want = _jax_decode(st, datas, schedule, clear_at_zero=True)
    assert _port_schedule(st, datas, schedule, batch) == want


def test_switch_to_level_zero_decodes_without_pp_f9(streams, jax_frames):
    """F9: after set_pplevel(0) every later frame equals a decode without
    pp. JAX's own decoder never reaches its level-0 branch and returns the
    last postprocessed frame instead, for every later frame."""
    st = streams["clip64x48_k8_q5"]
    datas = st[2]
    schedule = [7, 7, 7, 0, 0, 0, 0, 0]
    got = _port_schedule(st, datas, schedule)
    plain = jax_frames("clip64x48_k8_q5", 0)
    pp7 = jax_frames("clip64x48_k8_q5", 7)
    assert got[:3] == pp7[:3]
    assert got[3:] == plain[3:]
    assert plain[3:] != pp7[3:]
    jax = _jax_decode(st, datas, schedule)
    assert jax[3:] == [pp7[2]] * 5  # the fault, as JAX shows it
