"""The SATD + fitted-table mode decision of the PyTorch port's host
Encoder (mode_rd) and its R-D metrics collection (collect), against the
JAX package's host Encoder on the CPU.

The port's copies of encode/modedec.py and modedec_tables.py, its native
SATD functions (th_hadamard_batch, th_satd_halfpel_batch) and
tools/collect.py's fit are held to JAX's on the same numpy inputs. The
port's Encoder with mode_rd gives JAX's packets on clip64x48.i420 and the
4:2:2 and 4:4:4 64x48 raws; with collect, JAX's rows. Fault F12 (JAX's
mode_rd at speed levels 2-4 raises) has its test: the port's decision at
speed 2 equals JAX's _mode_decide_rd called on the same inputs.
Tolerance: none, every comparison is exact.
"""
import os

import numpy as np
import pytest
import torch

from tests.conftest import TESTDATA

# The tests run in several worker processes on a few CPUs: one torch
# thread each (their tensors are small, and idle intra-op threads spin).
torch.set_num_threads(1)

W, H = 64, 48


def raw_frames(fmt: int, n: int = 6):
    """The 64x48 test clips: clip64x48.i420 (4:2:0), clip64x48_422.raw
    and clip64x48_444.raw, planar Y, U, V per frame."""
    name = {0: "clip64x48.i420", 2: "clip64x48_422.raw",
            3: "clip64x48_444.raw"}[fmt]
    raw = np.fromfile(os.path.join(TESTDATA, name), np.uint8)
    cw = W if fmt == 3 else W // 2
    ch = H if fmt >= 2 else H // 2
    fsz = W * H + 2 * cw * ch
    out = []
    for i in range(min(n, len(raw) // fsz)):
        f = raw[i * fsz:(i + 1) * fsz]
        out.append([f[:W * H].reshape(H, W),
                    f[W * H:W * H + cw * ch].reshape(ch, cw),
                    f[W * H + cw * ch:].reshape(ch, cw)])
    return out


def _encoders(fmt, qi, kf=8, **kw):
    from theora_tpu.encode.encoder import Encoder as JEncoder
    from theora_tpu.info import TheoraInfo as JInfo
    from theora_tpu_torch.encode.encoder import Encoder
    from theora_tpu_torch.info import TheoraInfo

    args = dict(frame_width=W, frame_height=H, pic_width=W, pic_height=H,
                quality=qi, pixel_fmt=fmt, **kw)
    encs = [JEncoder(JInfo(**args)), Encoder(TheoraInfo(**args),
                                             device="cpu")]
    for e in encs:
        e.keyframe_freq = kf
    return encs


def _run(enc, frames):
    return [p.data for p in enc.flush_headers()] + [
        enc.encode_frame(fr).data for fr in frames]


def test_tables_are_the_jax_tables():
    from theora_tpu import modedec_tables as J
    from theora_tpu_torch import modedec_tables as P

    for name in ("NBINS", "NLOGQ", "SATD_EDGES", "LOGQ_ANCHORS", "RATE",
                 "RMSE"):
        assert getattr(P, name) == getattr(J, name), name


def test_interp_rows_satd_bin_and_dct_cost():
    from theora_tpu import tables as jtables
    from theora_tpu.encode import modedec as J
    from theora_tpu.quant import dequant_tables_init
    from theora_tpu_torch.encode import modedec as P

    dq = dequant_tables_init(jtables.DEF_QUANT_INFO)
    assert P.tables_available()
    rng = np.random.RandomState(3)
    for qi in range(64):
        for qti in (0, 1):
            for plc in (0, 1):
                a = P.interp_rows(dq, qi, qti, plc)
                b = J.interp_rows(dq, qi, qti, plc)
                assert np.array_equal(a[0], b[0])
                assert np.array_equal(a[1], b[1])
                for s in rng.randint(0, 30000, 8):
                    assert P.dct_cost(*a, s) == J.dct_cost(*b, s)
    edges = np.asarray(P._T.SATD_EDGES)
    for s in list(edges) + list(edges + 1) + list(edges - 1)[1:] + [
            0, 10 ** 6]:
        assert P.satd_bin(int(s)) == J.satd_bin(int(s))


def test_scheme_chooser():
    from theora_tpu.encode.modedec import SchemeChooser as J
    from theora_tpu_torch.encode.modedec import SchemeChooser as P

    rng = np.random.RandomState(5)
    p, j = P(), J()
    for mode in rng.choice(8, 300, p=[.4, .05, .2, .15, .05, .05, 0,
                                      .1]):
        for m in range(8):
            assert p.cost(m) == j.cost(m)
        p.update(int(mode))
        j.update(int(mode))
        assert np.array_equal(p.totals, j.totals)
        assert np.array_equal(p.ranks[0], j.ranks[0])


@pytest.mark.parametrize("bs", [8, 16])
def test_native_satd(bs):
    from theora_tpu import native as jn
    from theora_tpu_torch import native as pn

    rng = np.random.RandomState(bs)
    res = rng.randint(-255, 256, (40, 8, 8)).astype(np.int32)
    res[0] = 255
    res[1] = -255
    for a, b in zip(pn.hadamard_batch_native(res),
                    jn.hadamard_batch_native(res)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    cur = rng.randint(0, 256, (48, 64)).astype(np.uint8)
    ref = rng.randint(0, 256, (48 + 32, 64 + 32)).astype(np.uint8)
    n = 60
    fy = rng.randint(0, 48 - bs + 1, n) // 8 * 8
    fx = rng.randint(0, 64 - bs + 1, n) // 8 * 8
    mvx = rng.randint(-31, 32, n)
    mvy = rng.randint(-31, 32, n)
    mvx[:4] = [-31, 31, 0, 1]
    mvy[:4] = [31, -31, 1, 0]
    for a, b in zip(
            pn.satd_halfpel_batch_native(cur, ref, fy, fx, mvx, mvy, bs),
            jn.satd_halfpel_batch_native(cur, ref, fy, fx, mvx, mvy, bs)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("fmt,qi,sp", [(0, 40, 0), (0, 20, 1), (2, 48, 0),
                                       (3, 30, 0)])
def test_mode_rd_packets_equal_jax(fmt, qi, sp):
    frames = raw_frames(fmt)
    jenc, penc = _encoders(fmt, qi)
    for e in (jenc, penc):
        e.mode_rd = True
        if sp:
            e.set_splevel(sp)
    want = _run(jenc, frames)
    assert _run(penc, frames) == want
    # The decision is the fitted-table one: the native one differs.
    _, native = _encoders(fmt, qi)
    if sp:
        native.set_splevel(sp)
    assert _run(native, frames) != want


def test_mode_rd_options_equal_jax():
    frames = raw_frames(0, 5)
    jenc, penc = _encoders(0, 32)
    for e in (jenc, penc):
        e.mode_rd = True
        e.mode_rd_rate_scale = 4.0
        e.mode_rd_seed_levels = (0.5,)
    assert _run(penc, frames) == _run(jenc, frames)


def test_mode_rd_speed2_f12():
    """F12: JAX's Encoder with mode_rd at speed 2 raises (the block
    coordinates of its SATDs exist only at levels 0-1). The port encodes;
    its decision on each inter frame equals JAX's _mode_decide_rd on the
    same inputs (zero 4MV vectors, the JAX embedded decoder's
    references)."""
    from theora_tpu.encode.encoder import Encoder as JEncoder
    from theora_tpu_torch.encode import encoder as penc_mod

    frames = raw_frames(0, 4)
    jenc, penc = _encoders(0, 40)
    jenc.mode_rd = penc.mode_rd = True
    jenc.set_splevel(2)
    penc.set_splevel(2)
    jenc.flush_headers()
    jenc.encode_frame(frames[0])
    with pytest.raises(UnboundLocalError, match="blk_fy"):
        jenc.encode_frame(frames[1])

    # Replay each of the port's decisions through JAX's method, on a JAX
    # encoder whose embedded decoder has decoded the port's packets.
    jref, _ = _encoders(0, 40)
    jref.mode_rd = True
    jref.set_splevel(2)
    calls = []
    orig = penc_mod.Encoder._mode_decide_rd

    def spy(self, cur_y, prev_o, gold_o, mb_list, mvs, bmvs, blk_fy, blk_fx,
            mb_modes, mb_mvs):
        out = orig(self, cur_y, prev_o, gold_o, mb_list, mvs, bmvs, blk_fy,
                   blk_fx, mb_modes, mb_mvs)
        jm = np.zeros_like(mb_modes)
        jv = np.zeros_like(mb_mvs)
        g = self.geometry
        mb_fy = g.frag_y[g.mb_maps[mb_list, 0, 0]] * 8
        mb_fx = g.frag_x[g.mb_maps[mb_list, 0, 0]] * 8
        jref._frame_qis = None
        jref.qi = self.qi
        JEncoder._mode_decide_rd(jref, cur_y, prev_o, gold_o, mb_list,
                                 mb_fy, mb_fx, mvs, bmvs, blk_fy, blk_fx,
                                 jm, jv)
        calls.append(np.array_equal(jm[mb_list], mb_modes[mb_list])
                     and np.array_equal(jv[mb_list], mb_mvs[mb_list]))
        return out

    penc._mode_decide_rd = spy.__get__(penc)
    pk = [p.data for p in penc.flush_headers()]
    for fr in frames:
        pk.append(penc.encode_frame(fr).data)
        jref._dec.decode_packet(pk[-1])
    assert calls == [True] * 3


@pytest.mark.parametrize("fmt,qi,mode_rd,br", [
    (0, 40, False, 0), (0, 24, True, 0), (2, 48, True, 0), (3, 60, False, 0),
    (0, 40, False, 20_000)])
def test_collect_rows_equal_jax(fmt, qi, mode_rd, br):
    frames = raw_frames(fmt)
    kw = {"target_bitrate": br} if br else {}
    jenc, penc = _encoders(fmt, qi, kf=4, **kw)
    for e in (jenc, penc):
        e.mode_rd = mode_rd
        e.collect = []
    want = _run(jenc, frames)
    assert _run(penc, frames) == want
    if br:
        assert b"" in want[3:]       # a dropped frame collects no rows
    assert len(penc.collect) == len(jenc.collect) > 0
    for a, b in zip(penc.collect, jenc.collect):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_collect_tool_gather_fit_and_tables(tmp_path):
    from theora_tpu import tables as jtables
    from theora_tpu.quant import dequant_tables_init
    from theora_tpu.tools import collect as J
    from theora_tpu_torch.tools import collect as P

    clip = os.path.join(TESTDATA, "clip64x48.i420")
    clips = [(clip, W, H)]
    qis = [10, 40, 60]
    rows = P.gather(clips, qis, kf=4, max_frames=6, device="cpu")
    want = J.gather(clips, qis, kf=4, max_frames=6)
    assert np.array_equal(rows, want)
    rows_rd = P.gather(clips, [30], kf=4, max_frames=4, mode_rd=True,
                       device="cpu")
    assert np.array_equal(rows_rd, J.gather(clips, [30], kf=4,
                                            max_frames=4, mode_rd=True))
    dq = dequant_tables_init(jtables.DEF_QUANT_INFO)
    fitted = P.fit(rows, dq)
    for a, b in zip(fitted, J.fit(want, dq)):
        assert np.array_equal(a, b)
    P.write_tables(str(tmp_path / "p.py"), *fitted)
    J.write_tables(str(tmp_path / "j.py"), *fitted)
    p = (tmp_path / "p.py").read_text().splitlines()
    j = (tmp_path / "j.py").read_text().splitlines()
    assert p[0] == j[0].replace("theora_tpu.tools", "theora_tpu_torch.tools")
    assert p[1:] == j[1:]
    # The committed tables are what write_tables makes of their numbers.
    from theora_tpu_torch import modedec_tables as T

    P.write_tables(str(tmp_path / "t.py"), T.LOGQ_ANCHORS, T.RATE, T.RMSE)
    with open(os.path.join(os.path.dirname(T.__file__),
                           "modedec_tables.py")) as f:
        assert (tmp_path / "t.py").read_text() == f.read()


def test_mode_rd_prices_uncodable_vectors_f13():
    """F13: a 4MV block vector of -32 half-pel (the MV code carries
    -31..31) makes JAX's _mode_decide_rd raise KeyError; the port leaves
    4MV out of that MB's candidates. On the same inputs, at each seed
    level set (a lone 0.0 walk, which ignores MV bits, among them), the
    port's decision equals JAX's with an infinite price in its _mv_len
    cache (testdata/make_tools.py's f13_mv_len), and codes no such MB as
    4MV."""
    import importlib.util

    from theora_tpu.encode.encoder import Encoder as JEncoder

    spec = importlib.util.spec_from_file_location(
        "make_tools", os.path.join(TESTDATA, "make_tools.py"))
    mt = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mt)
    assert mt.f13_mv_len()[-32] == float("inf")
    frames = raw_frames(0, 2)
    jenc, penc = _encoders(0, 40)
    for e in (jenc, penc):
        e.mode_rd = True
        e.flush_headers()
        e.encode_frame(frames[0])
    g = penc.geometry
    cur = np.ascontiguousarray(frames[1][0][::-1])
    mb_list = np.flatnonzero(g.mb_valid)
    n = len(mb_list)
    mb_fy = g.frag_y[g.mb_maps[mb_list, 0, 0]] * 8
    mb_fx = g.frag_x[g.mb_maps[mb_list, 0, 0]] * 8
    blk_fy = (mb_fy[:, None] + np.array([0, 0, 8, 8])).reshape(-1)
    blk_fx = (mb_fx[:, None] + np.array([0, 8, 0, 8])).reshape(-1)
    rng = np.random.RandomState(6)
    mvs = rng.randint(-6, 7, (n, 2)).astype(np.int32)
    bmvs = rng.randint(-6, 7, (n, 4, 2)).astype(np.int32)
    bmvs[1] = ((4, 2), (-6, 4), (-32, 0), (8, -8))
    bmvs[4, 0, 1] = -32
    bmvs[4, 3] = -32
    # MB 1's blocks predicted exactly by its four vectors (block 2 over a
    # flat area, so at any vector), so that a walk which ignores MV bits
    # would code it as 4MV if 4MV were a candidate.
    by, bx = blk_fy[4:8], blk_fx[4:8]
    p0 = np.ascontiguousarray(frames[0][0][::-1])
    p0[max(by[2] - 2, 0):by[2] + 10, max(bx[2] - 18, 0):bx[2] + 10] = 128
    prev_o = np.pad(p0, 16, mode="edge")
    cur = cur.copy()
    for b in (0, 1, 3):
        y = by[b] + 16 + bmvs[1, b, 1] // 2
        x = bx[b] + 16 + bmvs[1, b, 0] // 2
        cur[by[b]:by[b] + 8, bx[b]:bx[b] + 8] = prev_o[y:y + 8, x:x + 8]
    cur[by[2]:by[2] + 8, bx[2]:bx[2] + 8] = 128
    args = (cur, prev_o, prev_o, mb_list)

    def plans():
        return np.zeros(g.nmbs, np.int32), np.zeros((g.nmbs, 2), np.int32)

    with pytest.raises(KeyError, match="-32"):
        JEncoder._mode_decide_rd(jenc, *args, mb_fy, mb_fx, mvs, bmvs,
                                 blk_fy, blk_fx, *plans())
    jenc._mv_len = mt.f13_mv_len()
    for levels in ((1.0, 0.25, 0.0), (0.0,), (0.5,)):
        jenc.mode_rd_seed_levels = penc.mode_rd_seed_levels = levels
        jm, jv = plans()
        JEncoder._mode_decide_rd(jenc, *args, mb_fy, mb_fx, mvs, bmvs,
                                 blk_fy, blk_fx, jm, jv)
        pm, pv = plans()
        penc._mode_decide_rd(*args, mvs, bmvs, blk_fy, blk_fx, pm, pv)
        assert np.array_equal(pm, jm) and np.array_equal(pv, jv), levels
        # No MB whose block vectors hold -32 is coded as 4MV.
        assert 7 not in pm[mb_list[[1, 4]]]
