"""Generate the lists that hold the PyTorch port's `th_*` encode API and
pre-1.0 `theora_*` shim (theora_tpu_torch.compat) to the JAX package's
(theora_tpu.compat), with the host Encoder under them.

- compat64x48_enc.sha256: the small cases of COMPAT_CASES (the 64x48
  clip, testdata/clip64x48.i420), one record line per packet, "<case>
  <SHA-256> <granulepos> <packetno> <b_o_s> <e_o_s>" (flags 0 or 1), the
  three headers first; the 2-pass case's pass-2 packets are followed by
  one line for the pass-1 metrics blob (granulepos -1, packetno -1);
- hd720_compat_cbr_enc.sha256: the 16 720p frames of
  make_hd720_enc.hd_frames() through th_enc_ctx, a keyframe every 8
  (TH_ENCCTL_SET_KEYFRAME_FREQUENCY_FORCE), info quality 0 (no quality
  floor) and a target bitrate of HD_CBR_RATE: one SHA-256 line per
  packet, the headers first (chip_smoke.py only);
- compat_cli.sha256: "<case> <SHA-256 of the .ogv>" per CLI_CASES case,
  `python -m theora_tpu.tools.enc FLAGS in.y4m out.ogv` (the JAX CLI's
  default host branch) on the 64x48 clip cut to a 60x44 picture, written
  by theora_tpu_torch.tools.y4m.write_y4m; the port's CLI takes the same
  flags after --host.

Every case runs through `run_case(name, compat, TheoraInfo, jax=...)`,
which the port's tests (tests/test_torch_compat.py) and chip_smoke.py
call with the port's module. The JAX th_enc_ctx rebuilds its Encoder
for TH_ENCCTL_SET_HUFFMAN_CODES, SET_QUANT_PARAMS, SET_COMPAT_CONFIG and
SET_VP3_COMPATIBLE and so drops the keyframe frequency, quality, speed
level, rate controller and VP3 mode set before (fault F10, ROADMAP.md
section 3); with jax=True, `run_case` sets them again on the rebuilt
Encoder, so the lists are those of a th_enc_ctx without F10, which the
port's is. TH_ENCCTL_SET_DUP_COUNT (case "dup_count") emits no dup
packet in either (F11).

The 720p rate: the JAX run at 2, 1 and 0.5 Mbit/s and 450, 400 and 350
kbit/s dropped no frame; at HD_CBR_RATE = 300 kbit/s it drops inter
frames 11, 12 and 15 (0-byte packets) and codes every other frame at qi
0 (keyframes 0 and 8 at 3,804 and 3,692 bytes, inter frames 1,240-3,159
bytes; 31,877 bytes in all), so the loop filter runs in the closed loop
(qi < 47). Each run took about 2 s on the CPU of an 8-core x86 machine.

Run from the repository root, for all lists or the named ones:

    python testdata/make_compat_enc.py [LIST ...]

It is not part of the port and pytest does not collect it; the tests and
chip_smoke.py load it by path.
"""
from __future__ import annotations

import hashlib
import importlib.util
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

W, H = 64, 48
HD_CBR_RATE, HD_KF = 300_000, 8


def _mk():
    spec = importlib.util.spec_from_file_location(
        "make_hd720_enc", os.path.join(HERE, "make_hd720_enc.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


mk = _mk()


def clip_frames(n: int = 8):
    """The 8 frames of clip64x48.i420, repeated from the start past 8."""
    frames = mk.clip64x48_frames(8)
    return [frames[i % 8] for i in range(n)]


def legacy_frames():
    """The frames of tests/test_compat.py's legacy round trip."""
    x = np.mgrid[0:H, 0:W][1]
    return [[((x * 3 + i * 5) % 256).astype(np.uint8),
             np.full((H // 2, W // 2), 90 + i, np.uint8),
             np.full((H // 2, W // 2), 160 - i, np.uint8)]
            for i in range(4)]


def rotated_huff_codes(tables):
    """A valid set of 80 Huffman codes other than the default: VP31's
    books rotated by 16 (each book stays a complete prefix code)."""
    return tables.VP31_HUFF_CODES[16:] + tables.VP31_HUFF_CODES[:16]


def compat_setup_header() -> bytes:
    """cif_k4_q40.tpkt's setup header (libtheora's encoder's)."""
    from theora_tpu_torch.tpkt import read_tpkt

    return read_tpkt(os.path.join(HERE, "cif_k4_q40.tpkt"))[2].data


# Ctl codes that rebuild the JAX th_enc_ctx's Encoder (F10).
_REBUILDS = (0, 2, 10, 32)


def ctl(ctx, req: int, buf=None, jax: bool = False):
    """ctx.ctl(req, buf); with jax, set again on a rebuilt Encoder what
    the rebuild dropped (F10)."""
    e = ctx._enc
    kept = (e.keyframe_freq, e.qi, e.sp_level, e.vp3_compatible, e.rc)
    ret = ctx.ctl(req, buf)
    if jax and req in _REBUILDS and ctx._enc is not e:
        n = ctx._enc
        n.keyframe_freq, n.qi = kept[0], kept[1]
        n.set_splevel(kept[2])
        n.vp3_compatible = n.vp3_compatible or kept[3]
        n.rc = kept[4]
    return ret


# name -> (info fields, ctls before the headers as (req, buf), {frame
# index: ctls before that frame}, frames); a buf named in _buf is a table
# or header of the module under test.
COMPAT_CASES = {
    # VBR with a keyframe every 4 at speed level 1.
    "vbr_k4_sp1": (dict(quality=40), [(4, 4), (14, 1)], {}, 8),
    # CBR at 8 kbit/s: inter frames drop as 0-byte packets.
    "cbr8k": (dict(quality=40, target_bitrate=8000), [(4, 8)], {}, 8),
    # CBR without drops (rate flags: overflow cap only), then a new
    # bitrate and a new rate buffer mid-stream.
    "cbr8k_nodrop_midstream": (
        dict(quality=40, target_bitrate=8000), [(4, 8), (20, 2)],
        {3: [(30, 16000)], 5: [(22, 24)]}, 8),
    # VP3 compatibility with VP31's tables: explicit drop frames.
    "vp3_8k": (dict(quality=40, target_bitrate=8000), [(4, 8), (10, 1)],
               {}, 8),
    # VP31's quantization parameters in the setup header.
    "vp31_quant": (dict(quality=40), [(4, 4), (2, "vp31_quant")], {}, 6),
    # Other Huffman codes in the setup header.
    "huff_rotated": (dict(quality=40), [(4, 4), (0, "rotated_huff")], {},
                     6),
    # Another encoder's setup header wholesale.
    "compat_config": (dict(quality=40), [(32, "setup_header")], {}, 3),
    # F11: the dup count is stored and no dup packet follows.
    "dup_count": (dict(quality=48), [(4, 4)], {2: [(18, 2)]}, 5),
}
TWOPASS_CASE, TWOPASS_RATE = "twopass_ctl", 64000
CASES = (*COMPAT_CASES, TWOPASS_CASE, "legacy")


def _buf(tables, buf):
    if buf == "vp31_quant":
        return tables.VP31_QUANT_INFO
    if buf == "rotated_huff":
        return rotated_huff_codes(tables)
    if buf == "setup_header":
        return compat_setup_header()
    return buf


def _info(TheoraInfo, **kw):
    return TheoraInfo(frame_width=W, frame_height=H, pic_width=W,
                      pic_height=H, **kw)


def _headers(ctx) -> list:
    out = []
    while (p := ctx.flushheader()) is not None:
        out.append(p)
    return out


def run_compat(name, compat, tables, TheoraInfo, jax=False, **alloc):
    """A COMPAT_CASES case: (headers + packets, the ctl return values)."""
    fields, pre, mid, n = COMPAT_CASES[name]
    ctx = compat.th_encode_alloc(_info(TheoraInfo, **fields), **alloc)
    rets = [ctl(ctx, req, _buf(tables, buf), jax) for req, buf in pre]
    pkts = _headers(ctx)
    frames = clip_frames(n)
    for i, f in enumerate(frames):
        rets += [ctl(ctx, req, _buf(tables, buf), jax)
                 for req, buf in mid.get(i, [])]
        ctx.ycbcr_in(f)
        pkts.append(ctx.packetout(i == n - 1))
    rets.append(ctx.ctl(compat.TH_ENCCTL_SET_QUALITY, 30))
    rets.append(ctx.ctl(compat.TH_ENCCTL_GET_SPLEVEL))
    rets.append(ctx.ctl(compat.TH_ENCCTL_SET_COMPAT_CONFIG,
                        compat_setup_header()))
    return pkts, rets


def run_twopass(compat, TheoraInfo, **alloc):
    """The 2-pass ctl protocol as encoder_example.c drives it: pass 1 with
    its placeholder header, per-frame records and summary (written over
    the placeholder), then pass 2 fed in 80-byte chunks by the pull
    protocol. Returns (pass-2 headers + packets, the pass-1 blob, the
    pass-1 packets, the placeholder)."""
    frames = [clip_frames(8)[i] for i in (0, 2, 4, 6, 1, 3)]
    enc1 = compat.th_encode_alloc(_info(
        TheoraInfo, quality=40, target_bitrate=TWOPASS_RATE), **alloc)
    pass1 = _headers(enc1)
    placeholder = enc1.ctl(compat.TH_ENCCTL_2PASS_OUT)
    body = b""
    for i, f in enumerate(frames):
        enc1.ycbcr_in(f)
        rec = enc1.ctl(compat.TH_ENCCTL_2PASS_OUT)
        assert isinstance(rec, bytes) and len(rec) == 12, rec
        body += rec
        pass1.append(enc1.packetout(i == len(frames) - 1))
    blob = enc1.ctl(compat.TH_ENCCTL_2PASS_OUT) + body
    enc2 = compat.th_encode_alloc(_info(
        TheoraInfo, quality=0, target_bitrate=TWOPASS_RATE), **alloc)
    pkts = _headers(enc2)
    pos = 0
    for i, f in enumerate(frames):
        while (want := enc2.ctl(compat.TH_ENCCTL_2PASS_IN)) > 0:
            used = enc2.ctl(compat.TH_ENCCTL_2PASS_IN,
                            blob[pos:pos + min(want, 80)])
            assert used > 0, used
            pos += used
        enc2.ycbcr_in(f)
        pkts.append(enc2.packetout(i == len(frames) - 1))
    return pkts, blob, pass1, placeholder


def run_legacy(compat, **init):
    """The pre-1.0 API: theora_encode_* on legacy_frames() at q40, a
    keyframe every 8, then theora_decode_* of the packets. Returns
    (headers + packets, the decoded frames, the granule time of the last
    packet)."""
    ci = compat.theora_info()
    compat.theora_info_init(ci)
    ci.width = ci.frame_width = W
    ci.height = ci.frame_height = H
    ci.quality = 40
    ci.keyframe_frequency_force = 8
    st = compat.theora_state()
    assert compat.theora_encode_init(st, ci, **init) == 0
    pkts = []
    while (p := compat.theora_encode_header(st)) is not None:
        pkts.append(p)
    frames = legacy_frames()
    for i, fr in enumerate(frames):
        assert compat.theora_encode_YUVin(st, fr) == 0
        ok, p = compat.theora_encode_packetout(st, i == len(frames) - 1)
        assert ok == 1
        pkts.append(p)
    di = compat.theora_info()
    compat.theora_info_init(di)
    for h in pkts[:3]:
        assert compat.theora_decode_header(di, None, h) == 0
    ds = compat.theora_state()
    assert compat.theora_decode_init(ds, di, **init) == 0
    outs = []
    for p in pkts[3:]:
        assert compat.theora_decode_packetin(ds, p) == 0
        outs.append([np.array(pl) for pl in compat.theora_decode_YUVout(ds)])
    t = compat.theora_granule_time(ds, ds.granulepos)
    compat.theora_clear(st)
    compat.theora_clear(ds)
    return pkts, outs, t


def blob_packet(Packet, blob: bytes):
    """The pass-1 blob as the 2-pass case's last record line."""
    return Packet(blob, granulepos=-1, packetno=-1)


def run_case(name, compat, tables, TheoraInfo, Packet, jax=False,
             **device):
    """The packets of any case of CASES, as compat64x48_enc.sha256 lists
    them; device goes to th_encode_alloc / theora_*_init (the port's)."""
    if name == TWOPASS_CASE:
        pkts, blob, _, _ = run_twopass(compat, TheoraInfo, **device)
        return pkts + [blob_packet(Packet, blob)]
    if name == "legacy":
        return run_legacy(compat, **device)[0]
    return run_compat(name, compat, tables, TheoraInfo, jax=jax,
                      **device)[0]


def run_hd720(compat, TheoraInfo, frames, **alloc):
    """The 720p frames through th_enc_ctx under HD_CBR_RATE: (headers +
    packets, the context)."""
    ctx = compat.th_encode_alloc(TheoraInfo(
        frame_width=1280, frame_height=720, pic_width=1280, pic_height=720,
        quality=0, target_bitrate=HD_CBR_RATE), **alloc)
    ctx.ctl(compat.TH_ENCCTL_SET_KEYFRAME_FREQUENCY_FORCE, HD_KF)
    pkts = _headers(ctx)
    for i, f in enumerate(frames):
        ctx.ycbcr_in(f)
        pkts.append(ctx.packetout(i == len(frames) - 1))
    return pkts, ctx


# The CLI cases: name -> the encoder CLI's flags (the port's after
# --host), on cli_frames().
CLI_CASES = {
    "b20k_drops": ["-q", "40", "-k", "8", "-b", "20000"],
    "b20k_no_drops": ["-q", "40", "-k", "8", "-b", "20000",
                      "--drop-frames", "0"],
    "twopass_b40k_buf12": ["-q", "0", "-k", "4", "-b", "40000",
                           "--two-pass", "--rate-buffer", "12"],
}


def cli_frames():
    return mk.cropped60x44(clip_frames(8))


def _jax_modules():
    from theora_tpu import compat, tables
    from theora_tpu.info import TheoraInfo
    from theora_tpu.tpkt import Packet

    return compat, tables, TheoraInfo, Packet


def _compat_records():
    compat, tables, TheoraInfo, Packet = _jax_modules()
    out = {}
    for name in CASES:
        out[name] = run_case(name, compat, tables, TheoraInfo, Packet,
                             jax=True)
        sizes = [len(p.data) for p in out[name][3:]]
        print(f"  {name}: data packet sizes {sizes}")
    return out


def _hd720():
    compat, _, TheoraInfo, _ = _jax_modules()
    pkts, ctx = run_hd720(compat, TheoraInfo, mk.hd_frames())
    for i, p in enumerate(pkts[3:]):
        d = p.data
        kind = ("dropped" if not d else
                "key" if not d[0] & 0x40 else "inter")
        qi = d[0] & 0x3F if d else "-"
        print(f"  frame {i}: {kind}, qi {qi}, {len(d)} bytes")
    print(f"  drops {ctx._enc.rc.ndrops}")
    return pkts


def _cli_hashes():
    import tempfile

    from theora_tpu.tools import enc as jenc
    from theora_tpu_torch.tools.y4m import write_y4m

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        y4m = os.path.join(tmp, "in.y4m")
        write_y4m(y4m, cli_frames())
        for name, flags in CLI_CASES.items():
            ogv = os.path.join(tmp, f"{name}.ogv")
            jenc.main([*flags, y4m, ogv])
            with open(ogv, "rb") as f:
                out[name] = hashlib.sha256(f.read()).hexdigest()
    return out


def main(names=None) -> None:
    sys.path.insert(0, os.path.dirname(HERE))
    import time

    import jax

    jax.config.update("jax_platforms", "cpu")
    for name in names or ["compat64x48_enc.sha256",
                          "hd720_compat_cbr_enc.sha256",
                          "compat_cli.sha256"]:
        t0 = time.perf_counter()
        if name == "compat64x48_enc.sha256":
            mk._write_records(name, _compat_records())
        elif name == "hd720_compat_cbr_enc.sha256":
            mk._write(name, _hd720())
        elif name == "compat_cli.sha256":
            mk._write_cli(name, _cli_hashes())
        else:
            raise SystemExit(f"unknown list {name}")
        print(f"{name}: {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main(sys.argv[1:])
