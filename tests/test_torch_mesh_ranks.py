"""The PyTorch port's mesh over torch.distributed ranks
(theora_tpu_torch/parallel/gop.py with parallel/ranks.py) on the CPU: one
world of 4 gloo processes, each rank on the CPU, runs every case of the
module, and every rank's packets must equal the list JAX's encode_clip_mesh
(or JAX's sequential encoder) made (testdata/make_hd720_enc.py). JAX's
invariant makes those lists valid for every mesh shape; JAX's own mesh is
not run here (tests/test_tpu_gop.py runs it). The shapes: the frag axis
alone ({gop 1, frag 4}), both axes ({2, 2}) and the gop axis alone ({4,
1}). Fault F8 of the reference (ROADMAP.md §3): JAX's rate_psum counts
each GOP frag_axis times; the port's counts it once. Tolerance: none,
every comparison is exact.

This module is also the workers' code: a worker loads it by path and runs
_world_main, so it imports neither JAX nor tests.conftest at module level.
"""
import hashlib
import importlib.util
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTDATA = os.path.join(ROOT, "testdata")
WORLD = 4

_spec = importlib.util.spec_from_file_location(
    "make_hd720_enc", os.path.join(TESTDATA, "make_hd720_enc.py"))
mk = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(mk)

# F8's case: the 12 noisy 64x48 frames of the CBR list at q40 in 3 GOPs,
# one GOP per rate window, with a target near the clip's real rate, so
# that a doubled count moves the qi.
F8_RATE, F8_WINDOW = 490_000, 1


def _info(w=64, h=48, quality=mk.SMALL_QI):
    from theora_tpu_torch.info import TheoraInfo

    return TheoraInfo(frame_width=w, frame_height=h, pic_width=w,
                      pic_height=h, quality=quality, fps_numerator=30,
                      fps_denominator=1)


def _hashes(pkts):
    return [hashlib.sha256(p if isinstance(p, bytes) else p.data).hexdigest()
            for p in pkts]


def _want(name):
    with open(os.path.join(TESTDATA, name)) as f:
        return f.read().split()


def _frames_11():
    return mk.moving_frames(64, 48, 0, mk.MESH_FRAMES, mk.MESH_SEED)


def _vbr(mesh):
    from theora_tpu_torch.parallel.gop import encode_clip_mesh

    return encode_clip_mesh(_frames_11(), _info(), mesh,
                            keyframe_freq=mk.SMALL_KF, qi=mk.SMALL_QI)


def _twopass(mesh):
    """The 2-pass list at rate window 2 with the port's own pass-1 blob
    (its hash is the list's last line)."""
    from theora_tpu_torch.encode.gop import GopEncoder
    from theora_tpu_torch.parallel.gop import encode_clip_mesh

    _, blob = GopEncoder(_info(quality=0), qi=mk.SMALL_QI,
                         device="cpu").encode_clip_pass1(
        _frames_11(), keyframe_freq=mk.SMALL_KF,
        target_bitrate=mk.MESH_2PASS_RATE)
    return encode_clip_mesh(
        _frames_11(), _info(quality=0), mesh, keyframe_freq=mk.SMALL_KF,
        qi=mk.SMALL_QI, target_bitrate=mk.MESH_2PASS_RATE, rate_window=2,
        twopass_data=blob, buf_delay=16) + [blob]


def _sp2(mesh):
    """mixed_frames() at q40 speed 2 (KR's fused entry) as two 2-frame
    GOPs in one encode_gops batch; headers first."""
    from theora_tpu_torch.parallel.gop import MeshGopEncoder

    frames = mk.mixed_frames()
    enc = MeshGopEncoder(mesh, _info(mk.MIXED_W, mk.MIXED_H),
                         qi=mk.MIXED_QI)
    enc.base.set_splevel(2)
    gops = [frames[:2], frames[2:]]
    out = [p.data for p in enc.base.flush_headers()]
    G = mesh.shape["gop"]
    for b0 in range(0, len(gops), G):
        batch = gops[b0:b0 + G]
        out += [d for pk in enc.encode_gops(
            batch + [batch[0]] * (G - len(batch)))[:len(batch)] for d in pk]
    return out


def _halftex(mesh):
    """The half-texture clip at q48 "auto" in 2-frame GOPs: the qi triple
    with per-block lambda scales, F4's near-tie on the second keyframe."""
    from theora_tpu_torch.parallel.gop import encode_clip_mesh

    return encode_clip_mesh(mk.halftexture_frames(),
                            _info(mk.MIXED_W, mk.MIXED_H, mk.HALFTEX_QI),
                            mesh, keyframe_freq=2, qi=mk.HALFTEX_QI)


def _cut_cbr(mesh):
    """Scene-cut GOPs of uneven length, CBR with a rate window of 3, which
    does not divide the gop axis."""
    from theora_tpu_torch.parallel.gop import encode_clip_mesh

    return encode_clip_mesh(mk.cut_frames(), _info(), mesh,
                            keyframe_freq=mk.CUT_KF, qi=mk.SMALL_QI,
                            target_bitrate=mk.MESH_CBR_RATE, rate_window=3,
                            auto_keyframe=True)


def _f8(mesh):
    from theora_tpu_torch.parallel.gop import encode_clip_mesh

    return encode_clip_mesh(mk.cbr_frames(), _info(quality=mk.CBR_QI), mesh,
                            keyframe_freq=mk.CBR_KF, qi=mk.CBR_QI,
                            target_bitrate=F8_RATE, rate_window=F8_WINDOW)


# name: (list, n_devices, frag_axis, run)
CASES = {
    "vbr_gop2_frag2": ("mesh64x48_vbr_enc.sha256", 4, 2, _vbr),
    "vbr_gop1_frag4": ("mesh64x48_vbr_enc.sha256", 4, 4, _vbr),
    "twopass_gop2_frag2": ("mesh64x48_twopass_enc.sha256", 4, 2, _twopass),
    "sp2_gop2_frag2": ("mesh96x64_sp2_enc.sha256", 4, 2, _sp2),
    "halftex_gop1_frag4": ("mesh96x64_halftex_q48_enc.sha256", 4, 4,
                           _halftex),
    "cut_cbr_gop4_frag1": ("mesh64x48_cut_cbr_enc.sha256", 4, 1, _cut_cbr),
    "f8_cbr_gop2_frag2": (None, 4, 2, _f8),
}


def _collectives(results):
    """What the world's collectives give: rate_psum at each shape over
    per-GOP values 1..G (and over a window shorter than the gop axis),
    and the shapes make_mesh refuses over 4 ranks."""
    from theora_tpu_torch.parallel.gop import make_mesh, rate_psum

    sums = {}
    for n, frag, bits in ((4, 2, [1, 2]), (4, 4, [1]), (4, 1, [1, 2, 3, 4]),
                          (8, 2, [1, 2, 3, 4]), (4, 1, [5, 7, 0])):
        mesh = make_mesh(n, frag_axis=frag, devices=["cpu"])
        sums[f"{n},{frag},{bits}"] = [mesh.shape, rate_psum(mesh, bits)]
    results["rate_psum"] = sums
    refused = []
    for n, frag in ((4, 3), (6, 4), (2, 1), (None, 8)):
        try:
            make_mesh(n, frag_axis=frag, devices=["cpu"])
            refused.append("made")
        except ValueError as e:
            refused.append(str(e))
    results["refused"] = refused


def _world_main(rank: int, port: str, out: str) -> None:
    """One rank of the module's world: every case, then the collectives;
    the results go to out as JSON ({case: per-packet SHA-256 list})."""
    import datetime
    import traceback

    import torch.distributed as dist

    from theora_tpu_torch.parallel.gop import make_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=WORLD, rank=rank,
                            timeout=datetime.timedelta(seconds=90))
    results = {"seconds": {}}
    try:
        for name, (_, n, frag, run) in CASES.items():
            t0 = time.perf_counter()
            mesh = make_mesh(n, frag_axis=frag, devices=["cpu"])
            results[name] = _hashes(run(mesh))
            results["seconds"][name] = time.perf_counter() - t0
        _collectives(results)
    except Exception:
        results["error"] = traceback.format_exc()
    with open(out, "w") as f:
        json.dump(results, f)
    if "error" in results:
        os._exit(1)  # the other ranks fail on the collective's timeout
    dist.barrier()
    dist.destroy_process_group()


_WORKER = r"""
import importlib.util, sys
sys.path.insert(0, sys.argv[2])
spec = importlib.util.spec_from_file_location("mesh_ranks", sys.argv[1])
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
mod._world_main(int(sys.argv[3]), sys.argv[4], sys.argv[5])
"""


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Runs the 4-rank world once: every process is waited for (at most
    240 s in all) or killed; returns each rank's results."""
    tmp = tmp_path_factory.mktemp("mesh_ranks")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = str(s.getsockname()[1])
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    env["OMP_NUM_THREADS"] = "1"
    outs = [str(tmp / f"rank{r}.json") for r in range(WORLD)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, os.path.abspath(__file__), ROOT,
         str(r), port, outs[r]], env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(WORLD)]
    deadline = time.time() + 240
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.time()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    logs = [p.stdout.read().decode(errors="replace")[-3000:] for p in procs]
    res = []
    for r, o in enumerate(outs):
        assert os.path.exists(o), f"rank {r} wrote no result: {logs[r]}"
        with open(o) as f:
            res.append(json.load(f))
    errors = [x["error"] for x in res if "error" in x]
    assert not errors and all(p.returncode == 0 for p in procs), \
        (errors or logs)
    return res


@pytest.mark.parametrize("name", [c for c in CASES if CASES[c][0]])
def test_ranks_packets_equal_jax_lists(world, name):
    """Every rank returns every packet of the JAX list (and, for the 2-pass
    list, the pass-1 blob) at its mesh shape."""
    want = _want(CASES[name][0])
    for r, res in enumerate(world):
        assert res[name] == want, f"rank {r}"


def test_rate_psum_counts_each_gop_once_over_ranks(world):
    """Over ranks rate_psum is the integer sum of the per-GOP values, each
    counted once, at every shape and on every rank: {2, 2} over 1, 2 gives
    3 where JAX's collective gives 6 (F8)."""
    want = {"4,2,[1, 2]": [{"gop": 2, "frag": 2}, 3],
            "4,4,[1]": [{"gop": 1, "frag": 4}, 1],
            "4,1,[1, 2, 3, 4]": [{"gop": 4, "frag": 1}, 10],
            "8,2,[1, 2, 3, 4]": [{"gop": 4, "frag": 2}, 10],
            "4,1,[5, 7, 0]": [{"gop": 4, "frag": 1}, 12]}
    for res in world:
        assert res["rate_psum"] == want


def test_ranks_refuse_shapes_that_do_not_divide(world):
    """Over 4 ranks: a frag axis that does not divide the world, places
    that frag_axis does not divide, a gop axis that does not divide over
    the rank groups, and a frag axis wider than the world raise
    ValueError, saying what is wrong."""
    for res in world:
        r = res["refused"]
        assert len(r) == 4 and "made" not in r
        assert "frag_axis=3 must divide" in r[0]
        assert "frag_axis=4 must divide" in r[1]
        assert "does not divide over the 4 rank groups" in r[2]
        assert "frag_axis=8 must divide" in r[3]


def test_f8_jax_rate_psum_counts_each_gop_frag_axis_times():
    """F8 in the reference: on the CPU's 8 virtual devices JAX's rate_psum
    over per-GOP bits 1..G returns the sum at frag_axis 1, twice the sum
    at frag_axis 2 and four times at 4."""
    from theora_tpu.parallel.gop import make_mesh as jax_mesh
    from theora_tpu.parallel.gop import rate_psum as jax_psum

    assert jax_psum(jax_mesh(8, frag_axis=1), np.arange(1, 9)) == 36
    assert jax_psum(jax_mesh(8, frag_axis=2), np.arange(1, 5)) == 2 * 10
    assert jax_psum(jax_mesh(4, frag_axis=4), np.arange(1, 2)) == 4 * 1


@pytest.fixture(scope="module")
def f8_sequential():
    """F8's case through the port's sequential GopEncoder.encode_clip."""
    from theora_tpu_torch.encode.gop import GopEncoder

    enc = GopEncoder(_info(quality=mk.CBR_QI), qi=mk.CBR_QI, device="cpu")
    return _hashes(enc.encode_clip(mk.cbr_frames(), keyframe_freq=mk.CBR_KF,
                                   target_bitrate=F8_RATE,
                                   rate_window=F8_WINDOW))


def test_f8_a_doubled_count_changes_the_bytes(f8_sequential, monkeypatch):
    """F8's case is sensitive to the count: the port's one-card mesh gives
    the sequential bytes, and with rate_psum patched to return twice the
    sum (JAX's count at frag_axis 2) it gives other bytes."""
    from theora_tpu_torch.parallel import gop
    from theora_tpu_torch.parallel.gop import make_mesh

    torch.set_num_threads(2)
    mesh = make_mesh(2, devices=["cpu"])
    assert _hashes(_f8(mesh)) == f8_sequential
    real = gop.rate_psum
    monkeypatch.setattr(gop, "rate_psum", lambda m, b: 2 * real(m, b))
    doubled = _hashes(_f8(mesh))
    assert doubled[:3] == f8_sequential[:3]
    assert doubled != f8_sequential


def test_f8_ranks_cbr_equals_sequential(world, f8_sequential):
    """F8's case over the {2, 2} mesh of ranks gives the port's sequential
    CBR bytes exactly, on every rank."""
    for res in world:
        assert res["f8_cbr_gop2_frag2"] == f8_sequential
