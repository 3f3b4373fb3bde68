"""The host Encoder's settings off its defaults, in the PyTorch port against
the JAX host Encoder on the CPU: auto_keyframe, skip_lambda_scale,
luma_ext_skip, coupled_skip with its four tunables (skip_other_scale,
skip_nonnomv, mb_skip_overhead_bits, mb_rollback), aq_estimate_margin and
use_trellis=False with adaptive quantization's qi triple.

Each case runs a testdata/make_hd720_enc.py HOST_CASES clip (64x48 or
96x64; coupled_skip's also in 4:2:2 and 4:4:4, their chroma repeated) with
the same attribute values on both encoders: the packets must be equal byte
for byte (data, granulepos, e_o_s). Each case's input must make JAX's
packets differ from JAX's under the case's base attributes (the defaults,
or coupled_skip alone for its tunables), so that no comparison is vacuous.
The constructed encoders' public attributes must agree, fast_recon (whose
two routes the port's closed loop on the card replaces) excepted.
Tolerance: none, every comparison is exact."""
import enum
import functools
import importlib.util
import os

import numpy as np
import pytest
import torch

from tests.conftest import TESTDATA
from theora_tpu_torch.constants import MODE_INTER_MV_FOUR, MODE_INTER_NOMV
from theora_tpu_torch.encode.encoder import Encoder
from theora_tpu_torch.info import TheoraInfo
from theora_tpu_torch.native import quantize_estimate_native

torch.set_num_threads(1)


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(TESTDATA, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


hs = _load("make_host_settings")
mk = hs.mk

COUPLED = {"coupled_skip": True}
# case -> (HOST_CASES clip, qi or None for the clip's, pixel format or None
# for the clip's, the attributes, the base attributes).
CASES = {
    "auto_keyframe": ("cut_q40", None, None, {"auto_keyframe": False}, {}),
    "skip_lambda_scale": ("halftex_q48", None, None,
                          {"skip_lambda_scale": 0.5}, {}),
    "luma_ext_skip": ("q40", None, None, {"luma_ext_skip": True}, {}),
    # At q48 the 64x48 clip codes 4MV macroblocks; the 96x64 mixed clip
    # has macroblocks whose luma all skips, so their mode is forced.
    "coupled_skip_4mv": ("q40", 48, None, COUPLED, {}),
    "coupled_skip_4mv_422": ("q40", 48, 2, COUPLED, {}),
    "coupled_skip_4mv_444": ("q40", 48, 3, COUPLED, {}),
    "coupled_skip_forced": ("mixed_q40", None, None, COUPLED, {}),
    "coupled_skip_forced_422": ("mixed_q40", None, 2, COUPLED, {}),
    "coupled_skip_forced_444": ("mixed_q40", None, 3, COUPLED, {}),
    "skip_other_scale": ("q40", None, None,
                         {**COUPLED, "skip_other_scale": 1.0}, COUPLED),
    "skip_nonnomv": ("q40", None, None, {**COUPLED, "skip_nonnomv": False},
                     COUPLED),
    "mb_skip_overhead_bits": ("mixed_q40", None, None,
                              {**COUPLED, "mb_skip_overhead_bits": 30.0},
                              COUPLED),
    "mb_rollback": ("mixed_q40", None, None, {**COUPLED, "mb_rollback": False},
                    COUPLED),
    "aq_estimate_margin": ("q40", 56, None, {"aq_estimate_margin": 8.0}, {}),
    "use_trellis_triple": ("q40", 56, None, {"use_trellis": False}, {}),
}


def _frames(clip, fmt):
    kind, *_ = mk.HOST_CASES[clip]
    frames = mk.host_frames(kind)
    if fmt is None:
        return frames
    # The 4:2:0 clip's chroma repeated down (4:2:2) or down and across
    # (4:4:4).
    return [[y] + [np.repeat(np.repeat(c, 2, 0), 2 if fmt == 3 else 1, 1)
                   for c in (u, v)] for y, u, v in frames]


def _encode(jax, case, base=False):
    clip, qi, fmt, attrs, base_attrs = CASES[case]
    _, _, _, fmt0, qi0, mode, splevel, kf = mk.HOST_CASES[clip]
    if jax:
        from theora_tpu.encode.encoder import Encoder as Enc
        from theora_tpu.info import TheoraInfo as Info
        kw = {}
    else:
        Enc, Info, kw = Encoder, TheoraInfo, {"device": "cpu"}
    return hs.encode(Enc, Info, _frames(clip, fmt),
                     qi0 if qi is None else qi,
                     base_attrs if base else attrs, keyframe_freq=kf,
                     pixel_fmt=fmt0 if fmt is None else fmt,
                     adaptive_quant=mode, splevel=splevel, **kw)


@functools.lru_cache(maxsize=None)
def _jax_packets(case, base=False):
    pkts, _ = _encode(True, case, base)
    return [(p.data, p.granulepos, p.e_o_s) for p in pkts]


@pytest.mark.parametrize("case", list(CASES))
def test_setting_equals_jax(case):
    pkts, _ = _encode(False, case)
    got = [(p.data, p.granulepos, p.e_o_s) for p in pkts]
    want = _jax_packets(case)
    bad = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
    assert len(got) == len(want) and not bad, f"{case}: packets {bad}"


@pytest.mark.parametrize("case", list(CASES))
def test_setting_changes_jax_packets(case):
    """The input of each case is one where the setting matters to JAX."""
    assert _jax_packets(case) != _jax_packets(case, base=True), case


def test_cases_reach_what_they_name(monkeypatch):
    """In each pixel format, the coupled _4mv cases enter the rollback with
    4MV macroblocks and the _forced cases force macroblocks' modes to
    INTER_NOMV; the triple cases code frames at more than one qi; the
    auto_keyframe case's default retries a frame as a keyframe."""
    counts = [0, 0]
    real = Encoder._coupled_transform_skip

    def recorded(self, planes, prev_rec, coded, frag_refi, frag_mode,
                 frag_mv, mb_modes, *args):
        before = mb_modes.copy()
        out = real(self, planes, prev_rec, coded, frag_refi, frag_mode,
                   frag_mv, mb_modes, *args)
        counts[0] += int((before == MODE_INTER_MV_FOUR).sum())
        counts[1] += int(((before != mb_modes)
                          & (mb_modes == MODE_INTER_NOMV)).sum())
        return out

    monkeypatch.setattr(Encoder, "_coupled_transform_skip", recorded)
    for kind, i in (("4mv", 0), ("forced", 1)):
        for suffix in ("", "_422", "_444"):
            counts[:] = [0, 0]
            _encode(False, f"coupled_skip_{kind}{suffix}")
            assert counts[i], (kind, suffix, counts)
    for case in ("aq_estimate_margin", "use_trellis_triple"):
        pkts = [type("P", (), {"data": d}) for d, _, _ in _jax_packets(case)]
        assert hs.multi_qi_frames(pkts), case
    keys = [len(d) and not d[0] & 0x40
            for d, _, _ in _jax_packets("auto_keyframe", base=True)[4:]]
    assert any(keys), "no inter frame was retried as a keyframe"


def test_quantize_estimate_equals_jax():
    """th_quantize_estimate of the port's library == the JAX package's, on
    random zig-zag DCT rows with and without the R/D sweeps."""
    from theora_tpu.native import quantize_estimate_native as jax_estimate

    rng = np.random.default_rng(25)
    dct = rng.integers(-600, 601, (300, 64)).astype(np.int16)
    dct[::3, 20:] = 0
    dq = rng.integers(6, 60, 64).astype(np.int32)
    nbt = rng.integers(2, 14, (5, 32)).astype(np.int64)
    for lam in (0.0, 3.5, 40.0):
        got = quantize_estimate_native(dct, dq, 21, lam, nbt)
        want = jax_estimate(dct, dq, 21, lam, nbt)
        assert all(np.array_equal(a, b) for a, b in zip(got, want)), lam


def _same(a, b) -> bool:
    """Equal values across the two packages: arrays by content, containers
    item by item, an enum by its value, an object of the packages' own
    classes (TheoraInfo, FrameGeometry) by the fields both have."""
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and np.array_equal(a, b)
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(_same(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b)))
    if isinstance(a, enum.Enum) or isinstance(b, enum.Enum):
        return getattr(a, "value", a) == getattr(b, "value", b)
    if hasattr(a, "__dict__"):
        common = vars(a).keys() & vars(b).keys()
        return (type(a).__name__ == type(b).__name__ and bool(common)
                and all(_same(vars(a)[k], vars(b)[k]) for k in common))
    return type(a) is type(b) and a == b


def test_public_attributes_equal_jax():
    """Every public attribute of a constructed JAX Encoder is on the
    port's with the same value (fast_recon excepted; info and geometry on
    the fields both packages' classes have); the tunables JAX
    reads through getattr take the values of its fallbacks
    (encoder.py:2053, 2313, 2319, 2330-2331)."""
    from theora_tpu.encode.encoder import Encoder as JaxEncoder
    from theora_tpu.info import TheoraInfo as JaxInfo

    kw = dict(frame_width=64, frame_height=48, pic_width=64, pic_height=48,
              quality=40)
    jax = JaxEncoder(JaxInfo(**kw))
    port = Encoder(TheoraInfo(**kw), device="cpu")
    names = [k for k in vars(jax) if not k.startswith("_")] + ["frame_qis"]
    missing = [k for k in names if not hasattr(port, k)]
    assert missing == ["fast_recon"], missing
    differ = [k for k in names if k != "fast_recon"
              and not _same(getattr(jax, k), getattr(port, k))]
    assert not differ, differ
    assert (port.luma_ext_skip, port.skip_other_scale, port.skip_nonnomv,
            port.mb_skip_overhead_bits, port.mb_rollback) == (
        False, 0.25, True, 6.0, True)
