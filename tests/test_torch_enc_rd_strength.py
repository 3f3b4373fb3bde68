"""The port's encoder CLI takes --rd-strength (fault F7, ROADMAP.md §3), on
the CPU against the JAX package: under -j, the GOP-parallel host encode
(parallel/transcode.py) against JAX's transcode(..., rd_strength=2); on
the device path, GopEncoder against JAX's TpuGopEncoder(rd_strength=2),
which JAX's own CLI does not reach (its --device drops the flag).
testdata/clip64x48.i420 at q40, a keyframe every 4. Tolerance: none,
packets are compared byte for byte."""
import importlib.util
import os

import pytest
import torch

from tests.conftest import TESTDATA

# The tests run in several worker processes on a few CPUs: one torch
# thread each (their tensors are small, and idle intra-op threads spin).
torch.set_num_threads(1)

_spec = importlib.util.spec_from_file_location(
    "make_hd720_enc", os.path.join(TESTDATA, "make_hd720_enc.py"))
mk = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(mk)

QI, KF = 40, 4


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _jax_info():
    from theora_tpu.info import TheoraInfo

    return TheoraInfo(frame_width=64, frame_height=48, pic_width=64,
                      pic_height=48, quality=QI, fps_numerator=30,
                      fps_denominator=1)


def _cli(tmp_path, frames, flags, name):
    """The port's CLI on frames with flags; the stream's packets as (data,
    granulepos) pairs, headers first."""
    from theora_tpu_torch.ogg import demux_stream
    from theora_tpu_torch.tools import enc
    from theora_tpu_torch.tools.y4m import write_y4m

    y4m, out = str(tmp_path / f"{name}.y4m"), str(tmp_path / f"{name}.ogv")
    write_y4m(y4m, frames)
    enc.main(["--device", "cpu", "-q", str(QI), "-k", str(KF), *flags, y4m,
              out])
    with open(out, "rb") as f:
        return [(p.data, p.granulepos) for p in demux_stream(f.read())]


def test_enc_cli_workers_take_rd_strength(tmp_path):
    """enc -j 2 --rd-strength 2 (two spawned processes, the host Encoder
    on the CPU) writes the packets of JAX's transcode(..., rd_strength=2)
    over 8 frames in 2 GOPs, which differ from JAX's at the default
    strength."""
    from theora_tpu.parallel.transcode import transcode

    frames = mk.clip64x48_frames(8)
    got = _cli(tmp_path, frames, ["-j", "2", "--rd-strength", "2"], "j2")
    want = [(p.data, p.granulepos) for p in transcode(
        frames, _jax_info(), keyframe_freq=KF, max_workers=2,
        rd_strength=2.0)]
    default = [p.data for p in transcode(frames, _jax_info(),
                                         keyframe_freq=KF, max_workers=2)]
    assert got == want
    assert [d for d, _ in want] != default


def test_enc_cli_device_path_takes_rd_strength(tmp_path):
    """enc --device cpu --rd-strength 2 writes the packets of JAX's
    TpuGopEncoder(rd_strength=2) over one 4-frame GOP; the default
    strength gives other packets."""
    from theora_tpu.encode.tpu_gop import TpuGopEncoder

    frames = mk.clip64x48_frames(KF)
    got = _cli(tmp_path, frames, ["--rd-strength", "2"], "rd2")
    want = TpuGopEncoder(_jax_info(), qi=QI, rd_strength=2.0).encode_clip(
        frames, keyframe_freq=KF)
    assert got == [(p.data, p.granulepos) for p in want]
    assert [d for d, _ in got] != [d for d, _ in
                                   _cli(tmp_path, frames, [], "rd3")]
