"""GOP-parallel transcode of the PyTorch port (parallel/transcode.py over
threads and processes, parallel/distributed.py over torch.distributed
"gloo" processes) on the CPU: byte-identical to one sequential host
Encoder and to the JAX package's transcode. Tolerance: none.

The multi-process runs bind to a free port, so they cannot collide with
other runs on the machine, and fail (not skip) on a timeout or a missing
output."""
import os
import pickle
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from tests.conftest import TESTDATA
from theora_tpu_torch.encode.encoder import Encoder
from theora_tpu_torch.info import TheoraInfo
from theora_tpu_torch.parallel import transcode as tmod
from theora_tpu_torch.parallel.distributed import distributed_transcode

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H = 64, 48


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _clip():
    raw = np.fromfile(os.path.join(TESTDATA, "clip64x48.i420"), np.uint8)
    fsz = W * H * 3 // 2
    return [[f[:W * H].reshape(H, W),
             f[W * H:W * H + fsz // 6].reshape(H // 2, W // 2),
             f[W * H + fsz // 6:].reshape(H // 2, W // 2)]
            for f in (raw[i * fsz:(i + 1) * fsz]
                      for i in range(len(raw) // fsz))]


def _info(**kw):
    return TheoraInfo(frame_width=W, frame_height=H, pic_width=W,
                      pic_height=H, quality=40, **kw)


def _sequential(frames, keyframe_freq, cuts=()):
    """One host Encoder on the CPU; keyframes forced at `cuts`."""
    enc = Encoder(_info(), device="cpu")
    enc.keyframe_freq = keyframe_freq
    out = enc.flush_headers()
    for i, fr in enumerate(frames):
        if i in cuts:
            enc._frames_since_keyframe = enc.keyframe_freq
        out.append(enc.encode_frame(fr, e_o_s=i == len(frames) - 1))
    return out


def _key(pkts):
    return [(p.data, p.granulepos, p.e_o_s, p.packetno) for p in pkts]


def test_threads_equal_sequential_and_jax():
    """max_workers=4 threads over clip64x48 at a keyframe every 4 (the
    case of tests/test_rate.py:test_gop_parallel_transcode_identical)."""
    from theora_tpu.info import TheoraInfo as JaxInfo
    from theora_tpu.parallel.transcode import transcode as jax_transcode

    frames = _clip()
    par = tmod.transcode(frames, _info(), keyframe_freq=4, max_workers=4,
                         device="cpu")
    assert _key(par) == _key(_sequential(frames, 4))
    want = jax_transcode(frames, JaxInfo(
        frame_width=W, frame_height=H, pic_width=W, pic_height=H,
        quality=40), keyframe_freq=4, max_workers=4)
    assert _key(par) == _key(want)


def test_process_retry_after_worker_kill(tmp_path, monkeypatch):
    """A spawned worker SIGKILLs itself on GOP 1; the GOP goes to a fresh
    pool and the output stays byte-identical to the sequential encode
    (tests/test_rate.py:test_gop_retry_after_worker_kill)."""
    frames = _clip()[:12]
    marker = tmp_path / "killed"
    monkeypatch.setenv(tmod._FAULT_ENV, f"1:{marker}")
    par = tmod.transcode(frames, _info(), keyframe_freq=4, max_workers=2,
                         use_processes=True, device="cpu")
    assert marker.exists(), "fault was never injected"
    monkeypatch.delenv(tmod._FAULT_ENV)
    assert _key(par) == _key(_sequential(frames, 4))


@pytest.mark.parametrize("fn", [tmod.transcode, distributed_transcode])
def test_cbr_refused(fn):
    """Per-GOP rate reservoirs would break the sequential byte identity
    (tests/test_tools.py:test_transcode_rejects_cbr)."""
    with pytest.raises(ValueError, match="CBR"):
        fn([], _info(target_bitrate=1000), device="cpu")


def test_one_process_recovers_dropped_gop():
    """No process group: a world of one. A GOP it drops after the
    assignment is re-encoded on rank 0, byte-identical to the healthy run
    (tests/test_rate.py:test_distributed_recovers_dropped_gop)."""
    frames = [
        [((np.mgrid[0:H, 0:W][1] * 2 + 7 * i) % 256).astype(np.uint8),
         np.full((H // 2, W // 2), 100 + i, np.uint8),
         np.full((H // 2, W // 2), 150 - i, np.uint8)]
        for i in range(12)]
    healthy = distributed_transcode(frames, _info(), keyframe_freq=4,
                                    device="cpu")
    lossy = distributed_transcode(frames, _info(), keyframe_freq=4,
                                  _drop_gops={1}, device="cpu")
    assert len(healthy) == 3 + 12
    assert _key(healthy) == _key(lossy) == _key(_sequential(frames, 4))


@pytest.mark.parametrize("bases", [[1, 5], [0, 5, 5], [0, 8, 5], [0, 18],
                                   []])
def test_bad_gop_bases_raise(bases):
    """JAX does not check gop_bases (a fault not copied)."""
    with pytest.raises(ValueError, match="gop_bases"):
        distributed_transcode(_clip()[:18], _info(), gop_bases=bases,
                              device="cpu")


_WORKER = r"""
import os, pickle, sys
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
rank, world, port, out = int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], \
    sys.argv[5]
bases = [int(b) for b in sys.argv[6].split(",") if b] or None
drop = {int(g) for g in sys.argv[7].split(",") if g} or None
with open(sys.argv[8], "rb") as f:
    frames = pickle.load(f)
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        world_size=world, rank=rank)
from theora_tpu_torch.info import TheoraInfo
from theora_tpu_torch.parallel.distributed import distributed_transcode
info = TheoraInfo(frame_width=64, frame_height=48, pic_width=64,
                  pic_height=48, quality=40)
pkts = distributed_transcode(frames, info, keyframe_freq=4, gop_bases=bases,
                             _drop_gops=drop, device="cpu")
dist.barrier()
dist.destroy_process_group()
if rank == 0:
    with open(out, "wb") as f:
        pickle.dump([(p.data, p.granulepos, p.e_o_s, p.packetno)
                     for p in pkts], f)
else:
    assert pkts == []
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_world(tmp_path, frames, world, bases="", lost=None):
    """world gloo processes over frames; rank `lost` drops its GOPs, and
    before it joins a first incarnation of it is killed. Returns rank 0's
    packets."""
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    clip = tmp_path / "frames.pkl"
    with open(clip, "wb") as f:
        pickle.dump(frames, f)
    out = tmp_path / "dist.pkl"
    port = str(_free_port())
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}

    def launch(rank, drop=""):
        return subprocess.Popen(
            [sys.executable, str(worker), REPO, str(rank), str(world), port,
             str(out), bases, drop, str(clip)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)

    procs = [launch(r) for r in range(world) if r != lost]
    if lost is not None:
        doomed = subprocess.Popen(
            [sys.executable, "-c", "import time; time.sleep(600)"], env=env)
        time.sleep(0.5)
        doomed.send_signal(signal.SIGKILL)
        doomed.wait(timeout=10)
        # Round-robin: the lost rank owns the GOPs gi % world == lost.
        ngops = len(bases.split(",")) if bases else -(-len(frames) // 4)
        procs.append(launch(lost, ",".join(
            str(g) for g in range(lost, ngops, world))))
    deadline = time.time() + 150
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.time()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    logs = [p.stdout.read().decode(errors="replace")[-2000:] for p in procs]
    assert all(p.returncode == 0 for p in procs), logs
    assert out.exists(), logs
    with open(out, "rb") as f:
        return pickle.load(f)


def test_two_processes_equal_sequential(tmp_path):
    """Two gloo processes over clip64x48 at a keyframe every 4
    (tests/test_distributed.py:test_two_process_distributed_matches_
    sequential)."""
    frames = _clip()
    got = _run_world(tmp_path, frames, 2)
    assert got == _key(_sequential(frames, 4))


def test_four_processes_scene_cut_gops_with_lost_worker(tmp_path):
    """Four gloo processes over the uneven scene-cut GOPs [0, 5, 8, 14];
    rank 2's first incarnation is killed before it joins, and the
    relaunched one has lost its GOP, which rank 0 re-encodes. The output
    equals one sequential Encoder forcing keyframes at the cuts
    (tests/test_distributed.py:test_four_process_scene_cut_gops_with_
    killed_worker)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "make_hd720_enc", os.path.join(TESTDATA, "make_hd720_enc.py"))
    mk = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mk)
    frames = mk.scene_cut_frames()
    cuts = mk.SCENE_CUTS
    got = _run_world(tmp_path, frames, 4,
                     bases=",".join(str(b) for b in cuts), lost=2)
    assert got == _key(_sequential(frames, 64, cuts))
