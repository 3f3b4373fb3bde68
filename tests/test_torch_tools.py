"""The PyTorch port's tools against the JAX package's on the CPU: metrics
and psnr, info, qualitysweep, crosscheck, profile, img2theora, play, the
Vorbis tier, ogg.mux_av and enc -a (theora_tpu_torch/tools/, with
--device cpu).

The metrics agree with JAX's to 1e-12 relative (float64, the same order
of sums; the reductions' orders differ); every other comparison is exact:
CLI lines, stream and file bytes, rows, per-packet statuses. The sweep's
host column runs live against JAX's tool; its device columns are held to
testdata/sweep96x80_dev.json, JAX's tool's rows (a live JAX device
encode costs too much test time). The crosscheck trials hold each
direction's stream to JAX's trial for the same seed, and the port's
decoder's statuses and bytes to JAX's host Decoder on that stream (the
reference binaries are not built here: JAX's trial raises on the missing
binary after writing its stream, which the test reads back).
"""
import glob
import json
import os
import subprocess
import sys
import wave

import numpy as np
import pytest
import torch

from tests.conftest import REPO_ROOT, TESTDATA

# The tests run in several worker processes on a few CPUs: one torch
# thread each (their tensors are small, and idle intra-op threads spin).
torch.set_num_threads(1)

W, H = 64, 48
CPU = ["--device", "cpu"]


def clip_frames(n=4):
    raw = np.fromfile(os.path.join(TESTDATA, "clip64x48.i420"), np.uint8)
    fsz = W * H * 3 // 2
    return [[raw[i * fsz:i * fsz + W * H].reshape(H, W),
             raw[i * fsz + W * H:i * fsz + W * H + fsz // 6].reshape(
                 H // 2, W // 2),
             raw[i * fsz + W * H + fsz // 6:(i + 1) * fsz].reshape(
                 H // 2, W // 2)] for i in range(n)]


def _close(a, b, rel=1e-12):
    if np.isnan(b) or np.isinf(b):
        return (np.isnan(a) and np.isnan(b)) or a == b
    return abs(a - b) <= rel * abs(b)


# ---------------------------------------------------------------- metrics
@pytest.mark.parametrize("shape", [(48, 64), (11, 11), (11, 30), (24, 13),
                                   (10, 12)])
def test_metrics_equal_jax(shape):
    from theora_tpu import metrics as J
    from theora_tpu_torch import metrics as P

    rng = np.random.RandomState(sum(shape))
    a = rng.randint(0, 256, shape).astype(np.uint8)
    b = np.clip(a.astype(int) + rng.randint(-9, 10, shape), 0,
                255).astype(np.uint8)
    with np.errstate(all="ignore"):
        for x, y in ((a, b), (a, a), (b, a)):
            assert _close(P.psnr(x, y), J.psnr(x, y))
            assert _close(P.ssim(x, y), J.ssim(x, y))
            assert _close(P.psnr(torch.as_tensor(x), torch.as_tensor(y)),
                          J.psnr(x, y))
        fa = [[a, a, a], [b, b, b]]
        fb = [[b, b, b], [b, a, a]]
        assert _close(P.clip_luma_psnr(fa, fb), J.clip_luma_psnr(fa, fb))
        assert _close(P.clip_luma_ssim(fa, fb), J.clip_luma_ssim(fa, fb))
        assert _close(P.clip_luma_ssim([], []), J.clip_luma_ssim([], []))


def test_ssim_under_the_window_raises_as_jax():
    from theora_tpu import metrics as J
    from theora_tpu_torch import metrics as P

    a = np.zeros((8, 30), np.uint8)
    with pytest.raises(ValueError, match="negative dimensions"):
        J.ssim(a, a)
    with pytest.raises(ValueError, match="negative dimensions"):
        P.ssim(a, a)


# ------------------------------------------------------------ psnr, info
def _y4ms(tmp_path):
    from theora_tpu.tools.y4m import write_y4m

    fa = clip_frames(4)
    rng = np.random.RandomState(2)
    fb = [[np.clip(p.astype(int) + rng.randint(-6, 7, p.shape), 0,
                   255).astype(np.uint8) for p in fr] for fr in fa]
    fb[1] = [p.copy() for p in fa[1]]      # an identical frame: inf dB
    pa, pb = str(tmp_path / "a.y4m"), str(tmp_path / "b.y4m")
    write_y4m(pa, fa)
    write_y4m(pb, fb)
    return pa, pb


@pytest.mark.parametrize("flags", [[], ["--quiet"], ["--no-ssim"]])
def test_psnr_cli_equals_jax(tmp_path, capsys, flags):
    from theora_tpu.tools import psnr as J
    from theora_tpu_torch.tools import psnr as P

    pa, pb = _y4ms(tmp_path)
    want = J.main([pa, pb, *flags])
    jout = capsys.readouterr()
    got = P.main([pa, pb, *flags, *CPU])
    pout = capsys.readouterr()
    assert pout.out.splitlines() == jout.out.splitlines()
    assert pout.err.splitlines() == jout.err.splitlines()
    assert got.keys() == want.keys()
    for k in want:
        assert _close(got[k], want[k])


def test_info_cli_equals_jax(tmp_path, capsys):
    from theora_tpu.tools import info as J
    from theora_tpu_torch.tools import info as P

    ogv = _ogv(tmp_path)
    for argv in ([], [ogv]):
        assert J.main(argv) == 0
        jl = capsys.readouterr().out.splitlines()
        assert P.main(argv) == 0
        pl = capsys.readouterr().out.splitlines()
        assert pl[0] == jl[0].replace("theora_tpu ", "theora_tpu_torch ", 1)
        assert pl[0].startswith("theora_tpu_torch 0.1.0 (")
        assert pl[1:] == jl[1:]
    assert len(pl) == 8


# ------------------------------------------------------------ qualitysweep
SWEEP = ["--size", "96x80", "--frames", "4", "--qis", "24,48", "--content",
         "smooth,textured"]


def test_qualitysweep_host_column_equals_jax_tool(monkeypatch, tmp_path):
    from theora_tpu.tools import qualitysweep as J
    from theora_tpu_torch.tools import qualitysweep as P

    path = str(tmp_path / "j.json")
    monkeypatch.setattr(sys, "argv", ["qualitysweep", *SWEEP, "--skip",
                                      "ref,device", "--json", path])
    J.main()
    with open(path) as f:
        want = json.load(f)
    got = P.main([*SWEEP, "--skip", "ref,device", *CPU])
    assert len(got) == len(want) == 4
    for r, w in zip(got, want):
        assert r.keys() == w.keys()
        for k in w:
            if isinstance(w[k], float):
                assert _close(r[k], w[k]), k
            else:
                assert r[k] == w[k], k


def test_qualitysweep_device_columns_equal_the_jax_record():
    from theora_tpu_torch.tools import qualitysweep as P

    with open(os.path.join(TESTDATA, "sweep96x80_dev.json")) as f:
        want = json.load(f)
    keep = {}
    got = P.main([*SWEEP, "--skip", "ref,host", "--adaptive", *CPU],
                 keep=keep)
    for r, w in zip(got, want):
        assert r.keys() == w.keys()
        for k in w:
            if isinstance(w[k], float):
                assert _close(r[k], w[k]), k
            else:
                assert r[k] == w[k], k
    # One encoder per adaptive setting: every stream's header carries the
    # first qi (JAX's cache).
    from theora_tpu_torch.headers import parse_info_header

    for (kind, qi, col), (pkts, rec) in (
            (k, v) for k, v in keep.items() if len(k) == 3):
        assert parse_info_header(pkts[0].data).quality == 24
        assert len(rec) == 4


def test_qualitysweep_without_ref_enc_names_it():
    from theora_tpu_torch.tools import qualitysweep as P

    assert not os.path.exists(P.REF_ENC)
    with pytest.raises(SystemExit, match="ref_enc.*--skip ref"):
        P.main([*SWEEP, *CPU])


# -------------------------------------------------------------- crosscheck
def _jax_side(stream):
    """JAX's host Decoder over a stream, driven as decode_port drives the
    port's decoder: (statuses or events, output bytes)."""
    from theora_tpu import compat
    from theora_tpu.decode.decoder import Decoder
    from theora_tpu.headers import parse_info_header, parse_setup_header
    from theora_tpu_torch.tools.crosscheck import MAX_HDR_AREA

    def fb(dec):
        return np.concatenate([x.reshape(-1) for x in dec.ycbcr_out()])

    mine, stats = [], []
    pk = stream.packets
    if stream.mode != "hdr":
        dec = Decoder(parse_info_header(pk[0].data),
                      parse_setup_header(pk[2].data))
        if stream.pp:
            dec.set_pplevel(stream.pp)
        for p in pk[3:]:
            try:
                ret = dec.decode_packet(p.data)
            except Exception:
                stats.append("bad")
                continue
            stats.append("dup" if ret == 1 else "ok")
            mine.append(fb(dec))
    else:
        state, dec = {}, None
        for p in pk:
            if dec is None:
                ret = compat.th_decode_headerin(state, p)
                stats.append(("H", ret))
                if ret != 0:
                    continue
                ti = state["info"]
                if ti.frame_width * ti.frame_height > MAX_HDR_AREA:
                    stats.append(("A", "skip"))
                    break
                try:
                    dec = Decoder(state["info"], state["setup"])
                except Exception:
                    stats.append(("A", "fail"))
                    break
            try:
                ret = dec.decode_packet(p.data)
            except Exception:
                stats.append(("S", -1))
                continue
            stats.append(("S", 1 if ret == 1 else 0))
            mine.append(fb(dec))
    return stats, (np.concatenate(mine) if mine else np.zeros(0, np.uint8))


def _fields(pkts):
    return [(p.data, p.granulepos, p.packetno, p.b_o_s, p.e_o_s)
            for p in pkts]


@pytest.mark.parametrize("direction,seed", [
    ("forward", 3), ("forward", 11), ("fuzz", 7), ("fuzz", 19),
    ("synth", 5), ("synth", 23), ("hdr", 2), ("hdr", 13)])
def test_crosscheck_trials_equal_jax(monkeypatch, tmp_path, direction,
                                     seed):
    from theora_tpu.tools import crosscheck as J
    from theora_tpu.tpkt import read_tpkt
    from theora_tpu_torch.tools import crosscheck as P

    jfn = {"forward": J.run_trial, "fuzz": J.run_fuzz_trial,
           "synth": J.run_synth_trial, "hdr": J.run_hdr_fuzz_trial}
    monkeypatch.chdir(tmp_path)       # JAX's binaries are relative paths
    rj = np.random.RandomState(seed)
    rp = np.random.RandomState(seed)
    tmp = str(tmp_path / "j")
    for trial in range(3):
        with pytest.raises(FileNotFoundError):
            jfn[direction](rj, trial, tmp=tmp)
        stream = P.BUILDERS[direction](rp, trial, "cpu")
        assert _fields(stream.packets) == _fields(read_tpkt(tmp + ".tpkt"))
        sj, sp = rj.get_state(), rp.get_state()
        assert sj[2] == sp[2] and np.array_equal(sj[1], sp[1])
        ref = _jax_side(stream)
        mine = P.decode_port(stream, "cpu")
        assert mine[0] == ref[0]
        assert P.compare(stream, ref, mine) is None, stream.desc


def test_crosscheck_without_reference_binaries_names_them(tmp_path):
    from theora_tpu_torch.tools import crosscheck as P

    rng = np.random.RandomState(1)
    for direction, binary in (("forward", "ref_dec"), ("fuzz", "ref_fuzz"),
                              ("hdr", "ref_hdr"), ("reverse", "ref_enc")):
        stream = P.BUILDERS[direction](rng, 0, "cpu")
        with pytest.raises(SystemExit, match=f"refbuild/build/{binary}"):
            P.run_ref(stream, str(tmp_path / "x"))


def test_crosscheck_fuzz_statuses_of_damaged_packets():
    """Damaged packets (a header bit set, all ones, all zeros, cut to one
    byte) give the port's PacketDecoder the statuses and bytes JAX's host
    Decoder gives them, including the frames after the damage."""
    from theora_tpu_torch.tools import crosscheck as P
    from theora_tpu_torch.tpkt import Packet

    rng = np.random.RandomState(4)
    stream = P.build_fuzz(rng, 0, "cpu")
    pk = stream.packets
    damaged = [b"\x80" + pk[4].data[1:], b"\xff" * 30, bytes(30),
               pk[4].data[:1]]
    stream.packets = pk[:4] + [Packet(d, granulepos=1) for d in damaged] \
        + pk[4:]
    ref = _jax_side(stream)
    mine = P.decode_port(stream, "cpu")
    assert ref[0][1:5] == ["bad", "bad", "ok", "ok"]
    assert mine[0] == ref[0]
    assert np.array_equal(mine[1], ref[1])


# ------------------------------------------------- ogg, vorbis and enc -a
def _write_wav(path, n=12000, rate=16000, ch=2):
    t = np.arange(n) / rate
    pcm = np.stack([np.sin(2 * np.pi * 440 * t),
                    0.5 * np.sin(2 * np.pi * 660 * t)][:ch], axis=1)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(ch)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes((pcm * 20000).astype("<i2").tobytes())
    return str(path)


def test_vorbis_roundtrip_and_mux_av_equal_jax(tmp_path):
    from theora_tpu import ogg as jogg
    from theora_tpu.tools import vorbis as J
    from theora_tpu.tpkt import Packet as JPacket
    from theora_tpu_torch import ogg
    from theora_tpu_torch.tools import vorbis as P
    from theora_tpu_torch.tpkt import Packet

    assert P.available() == J.available()
    if not J.available():
        pytest.skip("libvorbis is absent")
    wav = _write_wav(tmp_path / "a.wav")
    pcm, rate = P.read_wav(wav)
    jpcm, jrate = J.read_wav(wav)
    assert rate == jrate and np.array_equal(pcm, jpcm)
    streams = []
    for mod in (P, J):
        enc = mod.VorbisEncoder(pcm.shape[1], rate, 0.3)
        pk = enc.headers() + enc.encode(pcm[:7000]) + enc.encode(
            pcm[7000:]) + enc.finish()
        streams.append(pk)
        dec = mod.VorbisDecoder(pk[:3])
        out = np.concatenate([dec.decode(p) for p in pk[3:]])
        assert out.shape[1] == 2 and abs(len(out) - len(pcm)) < 2048
        streams.append(out)
    assert _fields(streams[0]) == _fields(streams[2])
    assert np.array_equal(streams[1], streams[3])
    video = [Packet(b"v%d" % i * 40, granulepos=i, packetno=i,
                    b_o_s=i == 0, e_o_s=i == 7) for i in range(8)]
    jvideo = [JPacket(p.data, granulepos=p.granulepos, packetno=p.packetno,
                      b_o_s=p.b_o_s, e_o_s=p.e_o_s) for p in video]

    def vt(gp):
        return (gp + 1) / 10.0

    def at(gp):
        return gp / rate

    got = ogg.mux_av(video, streams[0], vt, at)
    assert got == jogg.mux_av(jvideo, streams[2], vt, at)
    # Both logical streams come back out of it.
    per = {}
    for sn, p in ogg.PageReader(got).packets():
        per.setdefault(sn, []).append(p.data)
    assert sorted(map(len, per.values())) == sorted([8, len(streams[0])])


@pytest.mark.parametrize("branch", ["host", "host-cbr"])
def test_enc_audio_equals_jax(tmp_path, branch):
    from theora_tpu.tools import enc as J
    from theora_tpu.tools import vorbis
    from theora_tpu.tools.y4m import write_y4m
    from theora_tpu_torch.tools import enc as P

    if not vorbis.available():
        pytest.skip("libvorbis is absent")
    y4m = str(tmp_path / "in.y4m")
    write_y4m(y4m, clip_frames(5))
    wav = _write_wav(tmp_path / "a.wav", n=5000, ch=1)
    flags = ["-q", "40", "-k", "4", "-a", wav, "--audio-quality", "0.1"]
    if branch == "host-cbr":
        flags += ["-b", "40000"]
    J.main([y4m, str(tmp_path / "j.ogv"), *flags])
    P.main([y4m, str(tmp_path / "p.ogv"), *flags, "--host", *CPU])
    assert (tmp_path / "p.ogv").read_bytes() == \
        (tmp_path / "j.ogv").read_bytes()


def test_enc_audio_on_the_device_branch(tmp_path):
    """The device branch muxes the same audio with its own video."""
    from theora_tpu.tools import vorbis
    from theora_tpu.tools.y4m import write_y4m
    from theora_tpu_torch.ogg import PageReader, demux_stream
    from theora_tpu_torch.tools import enc as P

    if not vorbis.available():
        pytest.skip("libvorbis is absent")
    y4m = str(tmp_path / "in.y4m")
    write_y4m(y4m, clip_frames(3))
    wav = _write_wav(tmp_path / "a.wav", n=4000, ch=1)
    P.main([y4m, str(tmp_path / "v.ogv"), "-q", "40", *CPU])
    P.main([y4m, str(tmp_path / "av.ogv"), "-q", "40", "-a", wav, *CPU])
    P.main([y4m, str(tmp_path / "h.ogv"), "-q", "40", "-a", wav, "--host",
            *CPU])
    video = [p.data for p in demux_stream((tmp_path / "v.ogv").read_bytes())]

    def streams(path):
        per = {}
        for sn, p in PageReader(path.read_bytes()).packets():
            per.setdefault(sn, []).append(p.data)
        return per

    av = streams(tmp_path / "av.ogv")
    host = streams(tmp_path / "h.ogv")
    assert sorted(av.values(), key=len)[-1] == video or video in av.values()
    audio = [v for v in av.values() if v[0][:7] == b"\x01vorbis"]
    assert audio and audio == [v for v in host.values()
                               if v[0][:7] == b"\x01vorbis"]


# ------------------------------------------------------- play, img2theora
def _ogv(tmp_path, audio=False, fps=(30, 1)):
    from theora_tpu.tools import enc as J
    from theora_tpu.tools.y4m import write_y4m

    y4m = str(tmp_path / "src.y4m")
    write_y4m(y4m, clip_frames(4), fps=fps)
    out = str(tmp_path / ("av.ogv" if audio else "v.ogv"))
    flags = ["-q", "30", "-k", "3"]
    if audio:
        flags += ["-a", _write_wav(tmp_path / "s.wav", n=6000, ch=1)]
    J.main([y4m, out, *flags])
    return out


@pytest.mark.parametrize("audio", [False, True])
def test_play_y4m_equals_jax(tmp_path, capsys, audio):
    from theora_tpu.tools import play as J
    from theora_tpu.tools import vorbis
    from theora_tpu_torch.tools import play as P

    if audio and not vorbis.available():
        pytest.skip("libvorbis is absent")
    ogv = _ogv(tmp_path, audio)
    capsys.readouterr()
    J.main(["--stats-only", "-o", str(tmp_path / "j.y4m"), ogv])
    jerr = capsys.readouterr().err
    P.main(["--stats-only", "-o", str(tmp_path / "p.y4m"), ogv, *CPU])
    perr = capsys.readouterr().err
    assert (tmp_path / "p.y4m").read_bytes() == \
        (tmp_path / "j.y4m").read_bytes()
    # The header line, the audio line and the played count agree.
    jl, pl = jerr.splitlines(), perr.splitlines()
    assert pl[:-1] == jl[:-1]
    assert pl[-1].split(" in ")[0] == jl[-1].split(" in ")[0]
    if audio:
        assert any(ln.startswith("audio: Vorbis 1ch") for ln in pl)


def test_play_sdl_display(tmp_path):
    """play's SDL window path renders every frame under SDL's headless
    dummy driver (as tests/test_tools.py runs JAX's)."""
    pytest.importorskip("pygame")
    # At 1 fps: paced playback drops a frame whose decode ends more than
    # one frame time late, and the plain PyTorch path on a loaded CPU can
    # end 250 ms late (4 fps's frame time); a second leaves it room.
    ogv = _ogv(tmp_path, fps=(1, 1))
    env = dict(os.environ, SDL_VIDEODRIVER="dummy", SDL_AUDIODRIVER="dummy")
    r = subprocess.run(
        [sys.executable, "-m", "theora_tpu_torch.tools.play", *CPU, ogv],
        capture_output=True, text=True, timeout=120, env=env, cwd=REPO_ROOT)
    assert r.returncode == 0, r.stderr
    assert "display unavailable" not in r.stderr
    assert "played 4/4" in r.stderr


def test_img2theora_equals_jax(tmp_path):
    from PIL import Image

    from theora_tpu.tools import img2theora as J
    from theora_tpu_torch.tools import img2theora as P

    rng = np.random.RandomState(8)
    base = rng.randint(0, 256, (40, 52, 3)).astype(np.uint8)
    for i in range(3):
        Image.fromarray(np.roll(base, 2 * i, axis=1)).save(
            tmp_path / f"f{i:02d}.png")
    pat = str(tmp_path / "f*.png")
    assert J.main([pat, str(tmp_path / "j.ogv"), "-q", "44", "-k", "2"]) == 0
    assert P.main([pat, str(tmp_path / "p.ogv"), "-q", "44", "-k", "2",
                   *CPU]) == 0
    assert (tmp_path / "p.ogv").read_bytes() == \
        (tmp_path / "j.ogv").read_bytes()
    assert P.rgb_to_ycbcr420 is not J.rgb_to_ycbcr420
    for a, b in zip(P.rgb_to_ycbcr420(base), J.rgb_to_ycbcr420(base)):
        assert np.array_equal(a, b)


# ---------------------------------------------------------------- profile
@pytest.mark.parametrize("mode,label", [("encode", "theora.enc.idct_recon"),
                                        ("decode", "theora.dequant_idct")])
def test_profile_writes_a_chrome_trace(tmp_path, mode, label):
    from theora_tpu_torch.tools import profile as P

    out = tmp_path / mode
    assert P.main(["--mode", mode, "--out", str(out), "--frames", "3",
                   "--size", "64x48", *CPU]) == 0
    with open(out / "trace.json") as f:
        trace = json.load(f)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert label in names
    assert glob.glob(str(out / "*.json")) == [str(out / "trace.json")]
