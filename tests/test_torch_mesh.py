"""The PyTorch port's mesh GOP encoder (theora_tpu_torch/parallel/gop.py)
on the CPU: encode_clip_mesh and MeshGopEncoder at gop axes 1-4 against
the packet lists JAX's encode_clip_mesh made on an 8-device virtual mesh
(testdata/make_hd720_enc.py: VBR with a padded last GOP, CBR with scene-cut
GOPs and a rate window that does not divide the axis, 2-pass with the
port's own pass-1 blob, speed level 2, per-block lambda scales) and
against the sequential encoder; the encode-side kernels' plain versions with a segment axis against one call
per segment, exactly; the scan's pixel ops with a GOP axis against one
call per GOP; the ME plan over a GOP-major stack against JAX's
concatenated per-GOP plans; and the one-card mesh shapes the port does not
take.
JAX's own mesh is not run here (tests/test_tpu_gop.py runs it)."""
import hashlib
import importlib.util
import os

import numpy as np
import pytest
import torch

from tests.conftest import TESTDATA
from theora_tpu_torch.encode.gop import GopEncoder
from theora_tpu_torch.info import TheoraInfo
from theora_tpu_torch.parallel.gop import MeshGopEncoder, encode_clip_mesh, \
    make_mesh, rate_psum
from theora_tpu_torch.tools import bench_segments as bs

# The tests run in several worker processes on a few CPUs: one torch
# thread each (their tensors are small, and idle intra-op threads spin).
torch.set_num_threads(1)

_spec = importlib.util.spec_from_file_location(
    "make_hd720_enc", os.path.join(TESTDATA, "make_hd720_enc.py"))
mk = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(mk)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _info(w=64, h=48, quality=mk.SMALL_QI):
    return TheoraInfo(frame_width=w, frame_height=h, pic_width=w,
                      pic_height=h, quality=quality, fps_numerator=30,
                      fps_denominator=1)


def _mesh(gop):
    return make_mesh(gop, devices=["cpu"])


def _hashes(datas):
    return [hashlib.sha256(d if isinstance(d, bytes) else d.data).hexdigest()
            for d in datas]


def _want(name):
    with open(os.path.join(TESTDATA, name)) as f:
        return f.read().split()


def _frames_11():
    return mk.moving_frames(64, 48, 0, mk.MESH_FRAMES, mk.MESH_SEED)


@pytest.fixture(scope="module")
def pass1_blob():
    """The port's own pass 1 of the 11 frames (GopEncoder, info quality
    0, qi 40); its bytes must equal the JAX pass-1 blob in the list."""
    _, blob = GopEncoder(_info(quality=0), qi=mk.SMALL_QI,
                         device="cpu").encode_clip_pass1(
        _frames_11(), keyframe_freq=mk.SMALL_KF,
        target_bitrate=mk.MESH_2PASS_RATE)
    return blob


def _sp2(gop):
    """mixed_frames() at q40 speed 2 as two 2-frame GOPs, through
    MeshGopEncoder in batches of `gop` GOPs (a short batch padded with
    copies of its first GOP, whose packets are dropped): headers first."""
    frames = mk.mixed_frames()
    gops = [frames[:2], frames[2:]]
    enc = MeshGopEncoder(_mesh(gop), _info(mk.MIXED_W, mk.MIXED_H),
                         qi=mk.MIXED_QI)
    enc.base.set_splevel(2)
    out = [p.data for p in enc.base.flush_headers()]
    for b0 in range(0, len(gops), gop):
        batch = gops[b0:b0 + gop]
        out += [d for pk in enc.encode_gops(
            batch + [batch[0]] * (gop - len(batch)))[:len(batch)]
            for d in pk]
    return out


CASES = {
    "mesh64x48_vbr_enc.sha256": lambda gop, blob: encode_clip_mesh(
        _frames_11(), _info(), _mesh(gop), keyframe_freq=mk.SMALL_KF,
        qi=mk.SMALL_QI),
    "mesh64x48_cut_cbr_enc.sha256": lambda gop, blob: encode_clip_mesh(
        mk.cut_frames(), _info(), _mesh(gop), keyframe_freq=mk.CUT_KF,
        qi=mk.SMALL_QI, target_bitrate=mk.MESH_CBR_RATE, rate_window=3,
        auto_keyframe=True),
    "mesh64x48_twopass_enc.sha256": lambda gop, blob: encode_clip_mesh(
        _frames_11(), _info(quality=0), _mesh(gop),
        keyframe_freq=mk.SMALL_KF, qi=mk.SMALL_QI,
        target_bitrate=mk.MESH_2PASS_RATE, rate_window=2,
        twopass_data=blob, buf_delay=16) + [blob],
    "mesh96x64_sp2_enc.sha256": lambda gop, blob: _sp2(gop),
}


@pytest.mark.parametrize("gop", [1, 2, 3, 4])
@pytest.mark.parametrize("name", list(CASES))
def test_mesh_packets_equal_jax_lists(name, gop, request):
    """Every packet (and the 2-pass list's pass-1 blob) at gop axes 1-4
    equals JAX encode_clip_mesh's on its 8-device mesh."""
    blob = (request.getfixturevalue("pass1_blob") if "twopass" in name
            else None)
    assert _hashes(CASES[name](gop, blob)) == _want(name)


@pytest.fixture(scope="module")
def halftex_sequential():
    """The half-texture clip's packets from the sequential GopEncoder,
    once for the module."""
    return GopEncoder(_info(mk.MIXED_W, mk.MIXED_H, mk.HALFTEX_QI),
                      qi=mk.HALFTEX_QI, device="cpu").encode_clip(
        mk.halftexture_frames(), keyframe_freq=2)


@pytest.mark.parametrize("gop", [1, 2, 3, 4])
def test_mesh_with_lambda_scales_equals_sequential_encoder(
        gop, halftex_sequential):
    """The half-texture clip at q48 "auto" in 2-frame GOPs (the qi triple
    with per-block lambda scales on both GOPs): the mesh's packets equal
    the sequential GopEncoder's at every gop axis, and both equal JAX's
    (mesh96x64_halftex_q48_enc.sha256, which JAX's sequential encoder
    also gives). The second keyframe holds a trellis near-tie that the
    placement of XLA's fused multiply-adds decides (ROADMAP.md §3, F4)."""
    info = _info(mk.MIXED_W, mk.MIXED_H, mk.HALFTEX_QI)
    mesh = encode_clip_mesh(mk.halftexture_frames(), info, _mesh(gop),
                            keyframe_freq=2, qi=mk.HALFTEX_QI)
    want = _want("mesh96x64_halftex_q48_enc.sha256")
    assert _hashes(mesh) == _hashes(halftex_sequential) == want


def test_mesh_vbr_equals_sequential_encoder():
    """VBR over the mesh equals the sequential GopEncoder's encode_clip
    (JAX's invariant, tests/test_tpu_gop.py), the list above its witness."""
    seq = GopEncoder(_info(), qi=mk.SMALL_QI, device="cpu").encode_clip(
        _frames_11(), keyframe_freq=mk.SMALL_KF)
    assert _hashes(seq) == _want("mesh64x48_vbr_enc.sha256")


@pytest.mark.parametrize("scales,inter_frame", [(True, True),
                                                (False, False)])
def test_plain_kernels_with_segments_equal_one_call_per_segment(
        scales, inter_frame):
    """K2 -> KT -> K1 and K2 -> KR, each one call over 3 segments of 40
    blocks (a distinct qi triple and distinct lambdas per segment, and
    per-block lambda scales or none), equal 3 calls of one segment each,
    output for output; the segments' rows and lambdas are really used
    (swapping two segments' dequant rows changes every kernel's
    output)."""
    c = bs.segment_case(np.random.default_rng(7 + scales), 40, 3, "cpu",
                        scales=scales, inter_frame=inter_frame)
    one = bs.run_chain(c)
    assert bs.differ(one, bs.run_separately(c)) == []
    swapped = dict(c, deq=c["deq"][[1, 0, 2]].contiguous())
    assert bs.differ(one, bs.run_chain(swapped)) == list(one)


def test_pixel_ops_with_a_gop_axis_equal_one_call_per_gop():
    """MC gathers, blocks_to_plane, the loop filter (per-GOP limits, 0
    filtering nothing, and one limit for all) and fill_borders over 3
    GOPs' planes equal one call per plane."""
    from theora_tpu_torch.ops.loopfilter import loop_filter_plane
    from theora_tpu_torch.ops.mc import block_index_grid, blocks_to_plane, \
        mc_predict
    from theora_tpu_torch.pipeline import fill_borders

    rng = np.random.default_rng(3)
    nv, nh, py, px, G = 4, 6, 16, 16, 3
    n = nv * nh
    hp, wp = nv * 8 + 2 * py, nh * 8 + 2 * px
    planes = torch.from_numpy(rng.integers(0, 256, (G, hp, wp))
                              .astype(np.uint8))
    coded = torch.from_numpy(rng.random((G, nv, nh)) < 0.6)
    lims = [5, 0, 31]
    out = loop_filter_plane(planes, coded,
                            torch.tensor(lims, dtype=torch.int32), nv, nh,
                            py, px)
    same = loop_filter_plane(planes, coded,
                             torch.full((G,), 7, dtype=torch.int32), nv, nh,
                             py, px)
    for g in range(G):
        assert torch.equal(out[g], planes[g] if not lims[g] else
                           loop_filter_plane(planes[g], coded[g], lims[g],
                                             nv, nh, py, px))
        assert torch.equal(same[g], loop_filter_plane(planes[g], coded[g],
                                                      7, nv, nh, py, px))
    filled = fill_borders(planes.clone(), nv * 8, nh * 8, py, px)
    blocks = torch.from_numpy(rng.integers(0, 256, (G * n, 8, 8))
                              .astype(np.uint8))
    stacked = blocks_to_plane(blocks, nv, nh, py, px, planes=G)
    gold = torch.flip(planes, [0]).contiguous()
    grid = block_index_grid(nv, nh, py, px, wp, "cpu", G, hp)
    rs = torch.from_numpy(rng.integers(0, 3, G * n))
    offs = [torch.from_numpy(rng.integers(-8, 8, G * n)) for _ in range(4)]
    use2 = torch.from_numpy(rng.random(G * n) < 0.5)
    pred = mc_predict(planes, gold, grid, rs, *offs, use2)
    grid1 = block_index_grid(nv, nh, py, px, wp, "cpu")
    for g in range(G):
        sl = slice(g * n, (g + 1) * n)
        assert torch.equal(filled[g], fill_borders(
            planes[g].clone(), nv * 8, nh * 8, py, px))
        assert torch.equal(stacked[g], blocks_to_plane(blocks[sl], nv, nh,
                                                       py, px))
        assert torch.equal(pred[sl], mc_predict(
            planes[g], gold[g], grid1, rs[sl], *[o[sl] for o in offs],
            use2[sl]))


def test_me_plan_of_a_gop_major_stack_equals_jax_per_gop_plans():
    """One ME plan over G GOPs' frames (GOP-major, each GOP's keyframe
    its golden reference) gives, at every non-keyframe row, JAX's plan of
    the concatenated per-GOP (cur, prev, gold) triples
    (parallel/gop.py:174-189), all 11 outputs."""
    import jax.numpy as jnp

    from theora_tpu.ops import me_jax
    from theora_tpu_torch.ops import me

    G, F = 2, 3
    frames = mk.moving_frames(64, 48, 0, G * F, 21)
    ys = np.stack([f[0][::-1] for f in frames]).astype(np.uint8)
    gidx = np.repeat(np.arange(G) * F, F)[1:]
    got = me.plan_with_gold(torch.from_numpy(ys), torch.from_numpy(gidx))
    rows = [f - 1 for f in range(1, G * F) if f % F]
    per = ys.reshape(G, F, 48, 64)
    cur = np.concatenate([y[1:] for y in per])
    prev = np.concatenate([y[:-1] for y in per])
    gold = np.concatenate([np.broadcast_to(y[0], (F - 1, 48, 64))
                           for y in per])
    want = me_jax.plan(jnp.asarray(cur), jnp.asarray(prev),
                       jnp.asarray(gold))
    for o, w in zip(got, want):
        assert np.array_equal(o.numpy()[rows], np.asarray(w))


def test_mesh_shapes_the_port_does_not_take():
    """Without a process group a frag axis has no ranks to span, and a
    mesh over several devices is a process group of one rank per device:
    both raise ValueError saying so, as does an empty gop axis (the mesh
    over ranks: tests/test_torch_mesh_ranks.py); the one-card mesh's shape
    and the CBR collective."""
    with pytest.raises(ValueError, match="process group"):
        make_mesh(4, frag_axis=2, devices=["cpu"])
    with pytest.raises(ValueError, match="one rank each"):
        make_mesh(2, devices=["cpu", "cpu"])
    with pytest.raises(ValueError):
        make_mesh(0, devices=["cpu"])
    mesh = make_mesh(3, devices=["cpu"])
    assert mesh.shape == {"gop": 3, "frag": 1}
    assert mesh.device == torch.device("cpu")
    assert make_mesh(devices=["cpu"]).shape == {"gop": 1, "frag": 1}
    assert rate_psum(mesh, np.array([5, 7, 0], np.int32)) == 12
    enc = MeshGopEncoder(mesh, _info(), qi=40)
    assert enc.base.device == torch.device("cpu") and enc.base.qi == 40
    frames = _frames_11()
    with pytest.raises(ValueError):
        enc.encode_gops([frames[:2], frames[2:5]])
    with pytest.raises(ValueError):
        enc.encode_gops([frames[:2]], frame_qi=[[40]])
