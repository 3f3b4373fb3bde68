"""theora_tpu_torch/tools/roofline.py against theora_tpu/tools/roofline.py
on the CPU, at 64x48 and 3 frames.

The frames equal JAX's for the same arguments; the inputs the port's tool
builds for encode_plane give the JAX scan's quantized coefficients, coded
flags and reconstructed planes exactly, for every plane and both
quantizers (the trellis and the R/D quantizer), against JAX's
_scan_encode_plane on JAX's _plane_args; the tool prints JAX's stages in
JAX's order, JAX's model keys and bytes per frame, and no card on the
CPU. One run of the JAX tool serves the module (its compiles cost ~20 s).
"""
import json

import numpy as np
import pytest
import torch

from theora_tpu_torch.tools import roofline as P

# The tests run in several worker processes on a few CPUs: one torch
# thread each (their tensors are small, and idle intra-op threads spin).
torch.set_num_threads(1)

W, H, F = 64, 48, 3
ARGS = ["--size", f"{W}x{H}", "--frames", str(F), "--reps", "1", "--json"]


@pytest.fixture(scope="module")
def jax_run():
    """(rows, model) of one run of the JAX tool. Its scans are compiled
    with emit_recon=True, as test_scan_outputs_equal_jax calls them, so
    that test reuses three of the tool's four compiled scans; the tool
    reads only their first output, the same either way."""
    import functools

    from theora_tpu.encode import tpu_gop
    from theora_tpu.tools import roofline as J

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tpu_gop, "_scan_encode_plane", functools.partial(
            tpu_gop._scan_encode_plane, emit_recon=True))
        return J.main(ARGS)


@pytest.fixture(scope="module")
def encoders():
    from theora_tpu.encode.tpu_gop import TpuGopEncoder
    from theora_tpu.info import TheoraInfo as JInfo
    from theora_tpu_torch.encode.gop import GopEncoder
    from theora_tpu_torch.info import TheoraInfo

    kw = dict(frame_width=W, frame_height=H, pic_width=W, pic_height=H,
              quality=P.QI)
    return (TpuGopEncoder(JInfo(**kw), qi=P.QI),
            GopEncoder(TheoraInfo(**kw), qi=P.QI, device="cpu"))


@pytest.mark.parametrize("w,h,n,seed", [(64, 48, 3, 11), (96, 80, 5, 3)])
def test_synth_frames_equal_jax(w, h, n, seed):
    from theora_tpu.tools import roofline as J

    want = J._synth_frames(w, h, n, seed)
    got = P._synth_frames(w, h, n, seed)
    assert len(got) == len(want) == n
    for fg, fw in zip(got, want):
        for a, b in zip(fg, fw):
            assert a.dtype == b.dtype == np.uint8
            assert np.array_equal(a, b)


@pytest.mark.parametrize("use_trellis", [True, False],
                         ids=["trellis", "rdquant"])
@pytest.mark.parametrize("pli", [0, 1, 2])
def test_scan_outputs_equal_jax(jax_run, encoders, pli, use_trellis):
    """qout, coded and the reconstructed planes of every frame, exact."""
    from theora_tpu.encode.tpu_gop import _scan_encode_plane
    from theora_tpu.tools import roofline as J
    from theora_tpu_torch.encode.scan import encode_plane

    enc_j, enc_p = encoders
    frames = P._synth_frames(W, H, F)
    ja, jn = J._plane_args(enc_j, frames, F, pli)
    pa, pn = P._plane_args(enc_p, frames, F, pli)
    assert pn == jn
    want = _scan_encode_plane(*ja, use_trellis=use_trellis, emit_recon=True)
    qout, coded, qii, recon = encode_plane(**pa, use_trellis=use_trellis,
                                           emit_recon=True)
    assert qout.shape == (1, F, pn, 64)
    assert np.array_equal(qout[0].numpy(), np.asarray(want[0]))
    assert np.array_equal(coded[0].numpy(), np.asarray(want[1]))
    assert np.array_equal(recon[0].numpy(), np.asarray(want[2]))
    assert not qii.any()
    # Frame 0 is intra and codes every block; the inter frames skip some.
    assert coded[0, 0].all()


def test_main_prints_the_jax_stages_and_model(jax_run, capsys):
    rows_j, model_j = jax_run
    capsys.readouterr()
    rows, model = P.main(ARGS + ["--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert out == {"stages": rows, "model": model, "card": None}
    assert [r["stage"] for r in rows] == [r["stage"] for r in rows_j] \
        == list(P.STAGES)
    for r, rj in zip(rows, rows_j):
        assert r.keys() == rj.keys()
        assert r["ms_per_gop"] > 0 and r["ms_per_frame"] > 0
    assert list(model) == list(model_j)
    assert model["bytes_touched_per_frame_mb"] \
        == model_j["bytes_touched_per_frame_mb"]


def test_text_output_names_the_card_above_the_table(capsys):
    P.main(["--size", f"{W}x{H}", "--frames", "2", "--reps", "1",
            "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "card: None"
    assert lines[1].split() == ["stage", "ms/GOP", "ms/frame", "Mpix/s"]
    assert [ln.split()[0] for ln in lines[2:-1]] == list(P.STAGES)
    assert lines[-1].startswith("model: ")
