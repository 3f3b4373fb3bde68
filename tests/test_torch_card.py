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
        pytest.skip("needs a CUDA card: K1, K2, KT, KR, KM, KL, KS, KP and "
                    "the device decode and encode paths have no CPU mode")
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


def test_k1_kernel_matches_plain_at_three_qi_rows(card):
    """K1 as the encode scan launches it with three qi rows: 3 x 3,600
    blocks, a [1, 3, 2, 64] table, block r * 3600 + i row r of block i."""
    rng = np.random.default_rng(24)
    n, k = 3600, 3

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(card)

    coeffs = rng.integers(-32768, 32768, (k * n, 64), dtype=np.int16)
    args = (
        t(coeffs), t(coeffs[:, 0]),
        t(rng.integers(1, 32768, (1, 3, 2, 64), dtype=np.int16)),
        t(np.zeros(k * n, np.int32)),
        t(np.repeat(np.arange(k, dtype=np.uint8), n)),
        t(np.tile(rng.integers(0, 2, n).astype(np.uint8), k)),
        t(rng.random(k * n) < 0.3),
    )
    before = idct_cuda.dequantize_idct_frames.launches
    got = idct_cuda.dequantize_idct_frames(*args)
    torch.cuda.synchronize()
    assert idct_cuda.dequantize_idct_frames.launches == before + 1
    assert torch.equal(got, transforms.dequantize_idct_frames(*args))


@pytest.mark.parametrize("k", [1, 3])
def test_k1_encode_entry_matches_plain(card, k):
    """K1's encode entry (dequant + iDCT of each qi row, reconstruction,
    SSD and the chooser) against its plain version: 3,600 random blocks
    (a partial last CTA) with lambda scales, and the blocks whose rows tie
    in cost at K = 3; all five outputs exact."""
    from theora_tpu_torch.tools import bench_idct as bi

    rng = np.random.default_rng(25 + k)
    sets = [bi.recon_inputs(rng, 3600, k)]
    if k == 3:
        sets.append(bi.tie_inputs(rng, 3600))
    for arrays in sets:
        args = bi.recon_args(arrays, card)
        before = idct_cuda.idct_recon_choose.launches
        got = idct_cuda.idct_recon_choose(*args)
        torch.cuda.synchronize()
        assert idct_cuda.idct_recon_choose.launches == before + 1
        want = transforms.idct_recon_choose(*args)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.parametrize("name", ["clip64x48_k8_q5", "clip444"])
def test_golden_stream_on_card(card, name):
    from theora_tpu_torch.decode.batch import BatchDecoder
    from theora_tpu_torch.headers import parse_info_header, \
        parse_setup_header
    from theora_tpu_torch.tpkt import read_tpkt

    pkts = read_tpkt(os.path.join(TESTDATA, f"{name}.tpkt"))
    dec = BatchDecoder(parse_info_header(pkts[0].data),
                       parse_setup_header(pkts[2].data))
    from theora_tpu_torch.ops import loopfilter_cuda

    before = loopfilter_cuda.loop_filter_plane.launches
    outs = dec.decode_clip([p.data for p in pkts[3:]], batch=3)
    # Both are coded below q47: every frame's planes filter, through KL.
    assert loopfilter_cuda.loop_filter_plane.launches == before + 3 * len(
        outs)
    ref = np.fromfile(os.path.join(TESTDATA, f"{name}.ref.yuv"),
                      np.uint8).reshape(len(outs), -1)
    for i, o in enumerate(outs):
        assert np.array_equal(np.concatenate([p.reshape(-1) for p in o]),
                              ref[i]), f"frame {i}"


@pytest.mark.parametrize("k", [1, 2, 3])
def test_k2_kernel_matches_plain(card, k):
    """K2 at K qi rows on 14,400 random blocks (a 720p luma plane), one
    launch, exact; each row equals a one-row launch at that row."""
    from theora_tpu_torch.ops import fdct_cuda

    rng = np.random.default_rng(22)
    n = 14400

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(card)

    args = (t(rng.integers(-255, 256, (n, 64)).astype(np.int16)),
            t(rng.integers(1, 4097, (k, 2, 64)).astype(np.int16)),
            t(rng.integers(0, 2, n).astype(np.uint8)))
    before = fdct_cuda.fdct_quantize.launches
    q, d = fdct_cuda.fdct_quantize(*args)
    torch.cuda.synchronize()
    assert fdct_cuda.fdct_quantize.launches == before + 1
    qp, dp = transforms.fdct_quantize(*args)
    assert q.shape == (k, n, 64)
    assert torch.equal(q, qp) and torch.equal(d, dp)
    for r in range(k):
        q1, d1 = fdct_cuda.fdct_quantize(args[0], args[1][r:r + 1], args[2])
        assert torch.equal(q1[0], q[r]) and torch.equal(d1, d)


@pytest.mark.parametrize("rows", [1, 3])
def test_kt_kernel_matches_plain(card, rows):
    """KT on K2's outputs for 3,600 random residual blocks (one chroma
    plane of a 720p frame) at a random qi (and, at three rows, the qis
    10 and 20 above it, DC at the first), an intra and an inter frame,
    the inter one with per-block lambda scales in [0.1, 8] at three rows,
    exact: values, nonzero counts and DC-only flags."""
    from theora_tpu_torch import tables
    from theora_tpu_torch.encode.gop import trellis_bit_costs
    from theora_tpu_torch.ops import fdct_cuda, trellis_cuda
    from theora_tpu_torch.quant import dequant_tables_init

    rng = np.random.default_rng(23)
    n = 3600
    qi = int(rng.integers(0, 44))
    qis = [qi, qi + 10, qi + 20][:rows]
    deq = dequant_tables_init(tables.DEF_QUANT_INFO)[qis, 1].astype(np.int16)
    deq[:, :, 0] = deq[:1, :, 0]

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(card)

    nb = t(trellis_bit_costs(tables.VP31_HUFF_CODES))
    for qti in (0, 1):
        inter = (np.zeros(n, np.uint8) if qti == 0
                 else rng.integers(0, 2, n).astype(np.uint8))
        res = rng.integers(-255, 256, (n, 64)) // rng.integers(1, 40, (n, 1))
        q, d = fdct_cuda.fdct_quantize(t(res.astype(np.int16)), t(deq),
                                       t(inter))
        sc = (t(rng.uniform(0.1, 8.0, n).astype(np.float32))
              if rows > 1 and qti else None)
        args = (q, d, t(deq), t(inter),
                t(np.array([tables.RD_LAMBDA[0][qti][x] for x in qis],
                           np.float32)), nb, sc)
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


def test_kr_kernel_matches_plain(card):
    """KR on K2's outputs at K = 1, 2 and 3 (3,600 blocks, intra and
    inter mixed), the edge classes and the FMA-deciding blocks: values,
    counts and DC-only flags equal the plain version's, one launch each."""
    from theora_tpu_torch.ops import qrd_cuda
    from theora_tpu_torch.tools import bench_qrd

    cases = [a for _, a in bench_qrd.kr_cases(card, ((3600, 1),))]
    cases.append(bench_qrd.edge_args(card))
    cases += list(bench_qrd.fma_args(
        os.path.join(TESTDATA, "vectors", "qrd_fma_cases.npz"), card))
    before = qrd_cuda.quantize_rd.launches
    for args in cases:
        got = qrd_cuda.quantize_rd(*args)
        want = transforms.quantize_rd_rows(*args)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert qrd_cuda.quantize_rd.launches == before + len(cases)


def test_kr_fused_entry_matches_plain_and_chain(card):
    """KR's fused entry on random residuals at K = 1, 2 and 3 (3,600
    blocks: a partial CTA, intra and inter mixed) and over 3 segments of
    600 blocks at K = 3: values, counts and DC-only flags equal the plain
    version's and the K2 -> KR chain's, one launch each."""
    from theora_tpu_torch.ops import qrd_cuda
    from theora_tpu_torch.tools import bench_qrd, bench_segments

    cases = [a for _, a in bench_qrd.kr_cases(card, ((3600, 1),), True)]
    c = bench_segments.segment_case(np.random.default_rng(7), 600, 3, card)
    cases.append((c["res"], c["deq"], c["inter"], c["lam_q"]))
    before = qrd_cuda.fdct_quantize_rd.launches
    for args in cases:
        bench_qrd.check_fused(args)
    torch.cuda.synchronize()
    assert qrd_cuda.fdct_quantize_rd.launches == before + len(cases)


@pytest.mark.parametrize("h,w", [(48, 64), (144, 176), (720, 1280)])
def test_km_kernel_matches_plain(card, h, w):
    """KM on the frames of tools/bench_me.py:synthetic (frames that tie,
    and motion past the +-15 MB and +-13 block clamps) and, at 64x48 and
    176x144, on the rolled clip of test_me_plan_at_the_search_limits (a
    keyframe row included): all 11 outputs equal the plain version's,
    three launches per call."""
    from theora_tpu_torch.ops import me, me_cuda
    from theora_tpu_torch.tools import bench_me

    cases = []
    for ys in bench_me.synthetic(h, w, h).values():
        rows = len(ys) - 1
        cases.append((ys, np.where(np.arange(rows) < rows // 2, 0, 2)))
    if h < 720:
        rng = np.random.default_rng(h)
        noise = rng.integers(0, 256, (h, w)).astype(np.uint8)
        ys = np.stack([noise] + [np.roll(noise, sh, (0, 1)) for sh in (
            (20, 17), (-20, -17), (14, -14), (13, 13), (1, 0))])
        cases.append((ys, np.array([0, 0, 0, 4, 4])))
    before = me_cuda.plan_with_gold.launches
    for ys, gold in cases:
        ys = torch.from_numpy(np.ascontiguousarray(ys)).to(card)
        gold = torch.from_numpy(gold.astype(np.int64)).to(card)
        got = me_cuda.plan_with_gold(ys, gold)
        want = me.plan_with_gold(ys, gold)
        torch.cuda.synchronize()
        for g, x in zip(got, want):
            assert g.dtype == torch.int32 and torch.equal(g, x)
    assert me_cuda.plan_with_gold.launches == before + 3 * len(cases)


def test_km_frames_off_the_vector_alignment_match_plain(card):
    """Frames whose storage starts one byte past a 16-byte boundary (a
    contiguous view at an odd offset): KM stages them byte by byte instead
    of with vector loads, and its 11 outputs still equal the plain
    version's, on noise rolled past the search limits and by one pixel."""
    from theora_tpu_torch.ops import me, me_cuda

    rng = np.random.default_rng(9)
    noise = rng.integers(0, 256, (80, 96)).astype(np.uint8)
    frames = np.stack([noise] + [np.roll(noise, sh, (0, 1)) for sh in (
        (20, 17), (1, -1), (-3, 2))])
    store = torch.zeros(frames.size + 1, dtype=torch.uint8, device=card)
    ys = store[1:].view(frames.shape)
    ys.copy_(torch.from_numpy(frames))
    assert ys.data_ptr() % 16 == 1
    gold = torch.tensor([0, 0, 2], dtype=torch.int64, device=card)
    got = me_cuda.plan_with_gold(ys, gold)
    want = me.plan_with_gold(ys.contiguous(), gold)
    torch.cuda.synchronize()
    for g, x in zip(got, want):
        assert torch.equal(g, x)


@pytest.mark.parametrize("bad", [-1, 3])
def test_km_traps_a_gold_index_outside_the_frames(card, bad):
    """gold_idx outside [0, F) traps KM's search instead of reading past
    the frames; the error surfaces by the next synchronisation. In a child
    process, since a trap leaves the CUDA context unusable."""
    import subprocess
    import sys

    code = ("import torch\n"
            "from theora_tpu_torch.ops import me_cuda\n"
            "ys = torch.zeros((3, 32, 48), dtype=torch.uint8, "
            "device='cuda')\n"
            f"gold = torch.tensor([0, {bad}], device='cuda')\n"
            "try:\n"
            "    me_cuda.plan_with_gold(ys, gold)\n"
            "    torch.cuda.synchronize()\n"
            "except RuntimeError:\n"
            "    raise SystemExit(7)\n")
    r = subprocess.run([sys.executable, "-c", code],
                       cwd=os.path.dirname(TESTDATA), capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 7, r.stderr[-2000:]


@pytest.mark.parametrize("setting", ["speed 2", "cbr"])
def test_rate_and_speed_encodes_on_card_equal_cpu(card, setting):
    """Speed level 2 (KR) and CBR (per-frame qis, the loop filter below
    qi 47) at 64x48: the card's packets equal the CPU path's."""
    import importlib.util

    from theora_tpu_torch.encode.gop import GopEncoder
    from theora_tpu_torch.info import TheoraInfo

    spec = importlib.util.spec_from_file_location(
        "make_hd720_enc", os.path.join(TESTDATA, "make_hd720_enc.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    frames = mod.cbr_frames()
    info = TheoraInfo(frame_width=64, frame_height=48, pic_width=64,
                      pic_height=48, quality=40)
    out = []
    for dev in ("cuda", "cpu"):
        enc = GopEncoder(info, qi=40, device=dev)
        if setting == "speed 2":
            enc.set_splevel(2)
            out.append(enc.encode_clip(frames, keyframe_freq=4))
        else:
            out.append(enc.encode_clip(frames, keyframe_freq=4,
                                       target_bitrate=60_000, rate_window=1))
    assert [p.data for p in out[0]] == [p.data for p in out[1]]


def test_transcode_on_card_equals_cpu(card):
    """The device-resident transcode of a 64x48 stream with dup packets
    (in mid-batch, leading a batch, a batch of dups only): the card's
    packets equal the CPU path's."""
    import importlib.util

    from theora_tpu_torch.encode.gop import transcode_device
    from theora_tpu_torch.headers import parse_info_header, \
        parse_setup_header
    from theora_tpu_torch.tpkt import read_tpkt

    spec = importlib.util.spec_from_file_location(
        "make_hd720_enc", os.path.join(TESTDATA, "make_hd720_enc.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    pkts = read_tpkt(os.path.join(TESTDATA, mod.TC_SOURCE))
    info = parse_info_header(pkts[0].data)
    setup = parse_setup_header(pkts[2].data)
    datas = mod.dup_packets([p.data for p in pkts[3:]])
    out = [transcode_device(info, setup, datas, keyframe_freq=mod.TC_DUP_KF,
                            qi=mod.TC_QI, enc_kwargs={"device": dev})
           for dev in ("cuda", "cpu")]
    assert [p.data for p in out[0]] == [p.data for p in out[1]]


def test_mesh_on_card_equals_cpu(card):
    """encode_clip_mesh at 64x48 on a gop axis of 2 (the VBR clip of
    testdata/mesh64x48_vbr_enc.sha256, 3 GOPs: a full batch, then one
    padded with a copy of its first GOP): the card's packets equal the CPU
    path's."""
    import importlib.util

    from theora_tpu_torch.info import TheoraInfo
    from theora_tpu_torch.parallel.gop import encode_clip_mesh, make_mesh

    spec = importlib.util.spec_from_file_location(
        "make_hd720_enc", os.path.join(TESTDATA, "make_hd720_enc.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    frames = mod.moving_frames(64, 48, 0, mod.MESH_FRAMES, mod.MESH_SEED)
    info = TheoraInfo(frame_width=64, frame_height=48, pic_width=64,
                      pic_height=48, quality=40, fps_numerator=30,
                      fps_denominator=1)
    out = [encode_clip_mesh(frames, info, make_mesh(2, devices=[dev]),
                            keyframe_freq=4, qi=40)
           for dev in ("cuda", "cpu")]
    assert [p.data for p in out[0]] == [p.data for p in out[1]]


def _intra_cases():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "make_hd720_enc", os.path.join(TESTDATA, "make_hd720_enc.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("case,rate", [("q40", 0), ("q60", 0),
                                       ("q40", 200_000)])
def test_batch_intra_on_card_equals_cpu(card, case, rate):
    """BatchIntraEncoder at 64x48 on the card and on the CPU: one qi (K2
    over the batch), the intra triple (the host's quantizers) and rate
    control (K2 per frame at its qi) give the same packets."""
    from theora_tpu_torch.encode.intra import BatchIntraEncoder
    from theora_tpu_torch.info import TheoraInfo

    mk = _intra_cases()
    kind, w, h, fmt, qi, mode, _ = mk.INTRA_CASES[case]
    frames = mk.intra_frames(kind)
    out = []
    for dev in ("cuda", "cpu"):
        b = BatchIntraEncoder(TheoraInfo(
            frame_width=w, frame_height=h, pic_width=w, pic_height=h,
            quality=qi, pixel_fmt=fmt, target_bitrate=rate), device=dev)
        b.enc.adaptive_quant = mode
        out.append([p.data for p in b.flush_headers() + b.encode(frames)])
    assert out[0] == out[1]


def test_host_encoder_on_card_equals_cpu(card):
    """The host Encoder at 64x48 q40, a keyframe every 4 (the loop filter
    runs in the closed loop): its references decoded on the card and on
    the CPU give the same packets, and K1's decode entry runs on the
    card."""
    from theora_tpu_torch.encode.encoder import Encoder
    from theora_tpu_torch.info import TheoraInfo

    mk = _intra_cases()
    kind, w, h, fmt, qi, mode, splevel, kf = mk.HOST_CASES["q40"]
    frames = mk.host_frames(kind)
    out = []
    before = idct_cuda.dequantize_idct_frames.launches
    for dev in ("cuda", "cpu"):
        enc = Encoder(TheoraInfo(
            frame_width=w, frame_height=h, pic_width=w, pic_height=h,
            quality=qi, pixel_fmt=fmt), device=dev)
        enc.keyframe_freq = kf
        enc.adaptive_quant = mode
        out.append([(p.data, p.granulepos) for p in enc.flush_headers() + [
            enc.encode_frame(f) for f in frames]])
    assert out[0] == out[1]
    assert idct_cuda.dequantize_idct_frames.launches > before


def test_threaded_transcode_counts_every_k1_launch(card):
    """Eight threads of parallel/transcode.py on the card, with the
    interpreter switching threads every microsecond: K1's launch count
    (a read-modify-write under a lock) equals the sequential run's, and
    the packets are the same."""
    import sys

    from theora_tpu_torch.info import TheoraInfo
    from theora_tpu_torch.parallel.transcode import transcode

    mk = _intra_cases()
    frames = mk.moving_frames(64, 48, 0, 16, 11)
    info = TheoraInfo(frame_width=64, frame_height=48, pic_width=64,
                      pic_height=48, quality=40)
    runs = []
    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for workers in (1, 8):
            before = idct_cuda.dequantize_idct_frames.launches
            pkts = transcode(frames, info, keyframe_freq=2,
                             max_workers=workers, device="cuda")
            torch.cuda.synchronize()
            runs.append(([p.data for p in pkts],
                         idct_cuda.dequantize_idct_frames.launches - before))
    finally:
        sys.setswitchinterval(saved)
    assert runs[0] == runs[1]
    assert runs[0][1] > 0


def test_pipeline_cores_on_card_equal_cpu(card):
    """The three cores on the card (K2, K1's decode entry) give the CPU
    path's integers."""
    from theora_tpu_torch import pipeline

    rng = np.random.default_rng(31)
    blocks = rng.integers(0, 256, (2, 300, 8, 8), dtype=np.uint8)
    dq = rng.integers(4, 90, 64).astype(np.int32)
    n = 300
    inter = (blocks[0], blocks[1], rng.random(n) < 0.3, dq,
             rng.integers(4, 90, 64).astype(np.int32))
    h, w = 64, 80
    pos = rng.choice((h // 8 - 2) * (w // 8 - 2), 30, replace=False)
    coeffs = rng.integers(-40, 41, (30, 64)).astype(np.int32)
    deq = rng.integers(4, 60, (3, 64)).astype(np.int32)[
        rng.integers(0, 3, 30)]
    recon = (*[rng.integers(0, 256, (h, w), dtype=np.uint8)
               for _ in range(3)],
             ((pos // (w // 8 - 2) + 1) * 8).astype(np.int32),
             ((pos % (w // 8 - 2) + 1) * 8).astype(np.int32),
             coeffs, deq, rng.integers(-300, 300, 30).astype(np.int32),
             deq[:, 0].copy(), (coeffs[:, 1:] == 0).all(axis=1),
             rng.integers(0, 3, 30).astype(np.int32),
             *[rng.integers(-8, 9, 30).astype(np.int32) for _ in range(4)],
             rng.random(30) < 0.5)
    for fn, args in ((pipeline.intra_encode_core, (blocks, dq)),
                     (pipeline.inter_encode_core, inter),
                     (pipeline.recon_core, recon)):
        cpu = fn(*map(torch.from_numpy, args))
        gpu = fn(*[torch.from_numpy(np.asarray(a)).to(card) for a in args])
        cpu = cpu if isinstance(cpu, tuple) else (cpu,)
        gpu = gpu if isinstance(gpu, tuple) else (gpu,)
        for g, c in zip(gpu, cpu):
            assert torch.equal(g.cpu(), c)


def test_kl_kernel_matches_plain(card):
    """KL against its plain version (the plain filter, then the borders)
    byte for byte over the whole padded plane on every case of
    tools/bench_loopfilter.py:cases (the 720p planes, 4:2:2 and 4:4:4
    chroma, one row and one column, limits 1-63, the built corner
    patterns, the same at the kernel's tile seams, three planes in one
    launch with a zero limit), one launch per call, the input left as it
    was (bench_loopfilter.check raises on any difference)."""
    from theora_tpu_torch.tools.bench_loopfilter import check

    assert check(card) == (407, 0)


def test_ks_kernels_match_plain(card):
    """Each KS entry (mc_residual, skip_place, skip_rows, place_rows,
    mc_recon) against its plain version (ops/mc.py) byte for byte, every
    output and the planes' padding, on every case of
    tools/bench_mc.py:cases (the 720p planes, 4:2:2 and 4:4:4 chroma, 3
    segments, frag subsets, MVs at the padding's extremes in every corner,
    skip ties and ulp lambdas, key and inter steps, unfiltered and
    filtered) and the split form over 2 ranks, one launch per call, the
    inputs left as they were (bench_mc.check raises on any difference)."""
    from theora_tpu_torch.tools.bench_mc import check

    n, err = check(card)
    assert n > 40 and err == 0


def test_ks_fused_entries_match_their_chains(card):
    """K2's and KR's entries with KS's MC as their head and K1's entry with
    KS's MC, skip test and plane assembly around the chooser, against
    their plain chains and the kernel chains they replaced, byte for byte
    (the plane and its padding or the rows; qout, coded, qii), on every
    case of tools/bench_mc.py:fused_cases (the 720p planes, 4:2:2 and
    4:4:4 chroma, G = 1 and 3, prev and gold one buffer, a frag group's
    share, K = 1-3, the trellis and the R/D path, key and inter steps,
    borders on and off, skip ties and ulp lambdas), one launch each
    (bench_mc.check_fused raises on any difference)."""
    from theora_tpu_torch.tools.bench_mc import check_fused

    assert check_fused(card) == (72, 0)


def test_kp_kernel_matches_plain(card):
    """KP's deblock and dering launches against the plain version on the
    same inputs (on the CPU), byte for byte, on small planes at every pp
    level's plane and strength choice, into a padded plane's image."""
    from theora_tpu_torch.ops import postproc, postproc_cuda

    rng = np.random.default_rng(31)
    for nv, nh in ((1, 9), (7, 1), (6, 10)):
        src = rng.integers(0, 256, (8 * nv, 8 * nh), dtype=np.uint8)
        dcq = rng.integers(0, 64, (nv, nh), dtype=np.uint8)
        qi = rng.integers(0, 64, (nv, nh), dtype=np.uint8)
        tabs = (rng.integers(0, 300, 64, dtype=np.int32),
                -rng.integers(0, 200, 64, dtype=np.int32))
        for dering, strong, pli in ((False, False, 0), (True, False, 0),
                                    (True, True, 0), (True, True, 1)):
            args = [torch.from_numpy(a) for a in (src, dcq, qi, *tabs)]
            want = postproc.postprocess_plane(*args, dering, strong, pli)
            big = torch.zeros((8 * nv + 16, 8 * nh + 16), dtype=torch.uint8,
                              device=card)
            out = postproc_cuda.postprocess_plane(
                *[a.to(card) for a in args], dering, strong, pli,
                out=big[8:-8, 8:-8])
            torch.cuda.synchronize()
            assert torch.equal(out.cpu(), want)
            assert not big[:8].any() and not big[:, :8].any()


def test_kp_frames_match_plain(card):
    """KP's frame-axis entry (postprocess_frames: one deblock and one
    dering launch over a plane's frames) against the plain version frame
    by frame, byte for byte, on small stacks: F = 1, 3 and 8, dering off,
    on and strong mixed, a frame without pp left as it was, padded
    planes' images as sources, luma and chroma."""
    from theora_tpu_torch.ops import postproc, postproc_cuda

    rng = np.random.default_rng(32)
    for F, nv, nh, pli in ((1, 6, 10, 0), (3, 7, 1, 1), (8, 5, 9, 2)):
        frames = [f for f in range(F) if F < 3 or f != 1]
        dering = [k % 3 > 0 for k in range(len(frames))]
        strong = [k % 3 == 2 for k in range(len(frames))]
        tabs = (torch.from_numpy(rng.integers(0, 300, 64, dtype=np.int32)),
                torch.from_numpy(-rng.integers(0, 200, 64, dtype=np.int32)))
        ppq = torch.from_numpy(rng.integers(0, 64, (F, 2, nv, nh),
                                            dtype=np.uint8))
        srcs = []
        for _ in frames:
            big = torch.from_numpy(rng.integers(
                0, 256, (8 * nv + 16, 8 * nh + 32), dtype=np.uint8))
            srcs.append(big[8:-8, 16:-16])
        out = torch.full((F, 8 * nv, 8 * nh), 7, dtype=torch.uint8,
                         device=card)
        postproc_cuda.postprocess_frames(
            [s.to(card) for s in srcs], frames, out, ppq.to(card),
            *[t.to(card) for t in tabs], dering, strong, pli)
        torch.cuda.synchronize()
        for src, f, d, s in zip(srcs, frames, dering, strong):
            want = postproc.postprocess_plane(src, ppq[f, 0], ppq[f, 1],
                                              *tabs, d, s, pli)
            assert torch.equal(out[f].cpu(), want)
        if F >= 3:
            assert (out[1] == 7).all()
