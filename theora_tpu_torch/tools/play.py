"""Player: decode an Ogg Theora (optionally +Vorbis) file and display it
in an SDL window with real-time pacing, late-frame dropping, and playback
statistics -- the player_example analogue
(examples/player_example.c: SDL YUV overlay, audio-clock
sync, frame dropping).  The display rides pygame (SDL2); without a
display or with --no-display it degrades to the paced terminal/y4m-pipe
mode, so the tool works headless too.

Port of theora_tpu/tools/play.py: the frames come from the port's
PacketDecoder on --device (the card unless ``--device cpu``), the audio
from the port's Vorbis tier (tools/vorbis.py).

Usage: python -m theora_tpu_torch.tools.play [--stats-only] [--no-display]
           [-o pipe.y4m] [--device D] in.ogv
Keys: q / Esc / window close quit playback.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def _yuv_to_rgb(y, cb, cr, hdec, vdec):
    """BT.601 full-range-Y'CbCr -> RGB888, chroma nearest-upsampled."""
    if vdec:
        cb = np.repeat(cb, 2, axis=0)
        cr = np.repeat(cr, 2, axis=0)
    if hdec:
        cb = np.repeat(cb, 2, axis=1)
        cr = np.repeat(cr, 2, axis=1)
    h, w = y.shape
    yy = y.astype(np.int32)
    u = cb[:h, :w].astype(np.int32) - 128
    v = cr[:h, :w].astype(np.int32) - 128
    # Fixed-point BT.601 (the reference player's overlay does this in
    # hardware; player_example.c hands SDL the planes raw).
    r = yy + ((91881 * v) >> 16)
    g = yy - ((22554 * u + 46802 * v) >> 16)
    b = yy + ((116130 * u) >> 16)
    rgb = np.stack([r, g, b], axis=-1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


class _SdlDisplay:
    """pygame/SDL window + optional mixer audio with an audio clock."""

    def __init__(self, w, h, title):
        os.environ.setdefault("SDL_AUDIODRIVER", "dummy")
        os.environ.setdefault("PYGAME_HIDE_SUPPORT_PROMPT", "1")
        import pygame  # noqa: F401 -- hard dependency of this class

        self.pygame = pygame
        pygame.display.init()
        self.screen = pygame.display.set_mode((w, h))
        pygame.display.set_caption(title)
        self.audio = None
        self.frames_shown = 0

    def start_audio(self, rate, channels):
        pg = self.pygame
        try:
            pg.mixer.init(frequency=rate, channels=channels, size=-16)
            self.audio = {"rate": rate, "ch": channels,
                          "queued": 0, "t0": None,
                          "chan": pg.mixer.Channel(0)}
            return True
        except Exception:
            return False

    def queue_audio(self, pcm_f32):
        """Queue float PCM [n, ch]; returns the audio clock in seconds."""
        a = self.audio
        pg = self.pygame
        pcm = (np.ascontiguousarray(pcm_f32) * 32767.0).clip(
            -32768, 32767
        ).astype(np.int16)
        if a["ch"] == 1:
            pcm = pcm.reshape(-1)
        snd = pg.sndarray.make_sound(pcm)
        if a["t0"] is None:
            a["t0"] = time.perf_counter()
            a["chan"].play(snd)
        else:
            a["chan"].queue(snd)
        a["queued"] += len(pcm_f32)

    def audio_clock(self):
        a = self.audio
        if a is None or a["t0"] is None:
            return None
        return time.perf_counter() - a["t0"]

    def show(self, rgb):
        pg = self.pygame
        pg.surfarray.blit_array(self.screen, rgb.transpose(1, 0, 2))
        pg.display.flip()
        self.frames_shown += 1

    def pump(self):
        """Process events; returns False when the user asked to quit."""
        pg = self.pygame
        for ev in pg.event.get():
            if ev.type == pg.QUIT:
                return False
            if ev.type == pg.KEYDOWN and ev.key in (
                pg.K_q, pg.K_ESCAPE,
            ):
                return False
        return True

    def close(self):
        self.pygame.quit()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("input")
    ap.add_argument("-o", "--output", default=None,
                    help="also stream decoded frames to a y4m file/pipe")
    ap.add_argument("--stats-only", action="store_true",
                    help="decode as fast as possible, no pacing")
    ap.add_argument("--no-display", action="store_true",
                    help="terminal mode: never open an SDL window")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the decoder; 'cpu' for the CPU")
    args = ap.parse_args(argv)

    from theora_tpu_torch import resolve_device
    from theora_tpu_torch.decode.scalar import PacketDecoder
    from theora_tpu_torch.headers import (
        parse_comment_header,
        parse_info_header,
        parse_setup_header,
    )
    from theora_tpu_torch.ogg import demux_stream

    device = resolve_device(args.device)

    data = open(args.input, "rb").read()
    pkts = demux_stream(data)
    info = parse_info_header(pkts[0].data)
    comments = parse_comment_header(pkts[1].data)
    setup = parse_setup_header(pkts[2].data)
    fps = info.fps_numerator / max(info.fps_denominator, 1)
    print(
        f"{info.pic_width}x{info.pic_height} @ {fps:.3f} fps, "
        f"fmt {int(info.pixel_fmt)}, vendor {comments['vendor']!r}",
        file=sys.stderr,
    )

    disp = None
    if not args.no_display and not args.stats_only:
        try:
            disp = _SdlDisplay(
                int(info.pic_width), int(info.pic_height),
                os.path.basename(args.input),
            )
        except Exception as e:
            print(f"display unavailable ({e}); terminal mode",
                  file=sys.stderr)

    # A/V files: decode the Vorbis stream; if a mixer exists play it and
    # let the audio clock pace video (the reference's sync model),
    # otherwise just report it.
    adec, apkts = None, None
    try:
        from theora_tpu_torch.ogg import PageReader
        from theora_tpu_torch.tools import vorbis as _vb

        astreams = {}
        for sn, p in PageReader(data).packets():
            astreams.setdefault(sn, []).append(p)
        apkts = next(
            (ps for ps in astreams.values()
             if ps and ps[0].data[:7] == b"\x01vorbis"), None,
        )
        if apkts and _vb.available():
            adec = _vb.VorbisDecoder(apkts[:3])
            have_mixer = disp is not None and disp.start_audio(
                adec.rate, adec.channels
            )
            if have_mixer:
                for p in apkts[3:]:
                    pcm = adec.decode(p)
                    if len(pcm):
                        disp.queue_audio(pcm)
                print(
                    f"audio: Vorbis {adec.channels}ch @ {adec.rate} Hz "
                    "(mixer)", file=sys.stderr,
                )
            else:
                nsamp = sum(len(adec.decode(p)) for p in apkts[3:])
                print(
                    f"audio: Vorbis {adec.channels}ch @ {adec.rate} Hz, "
                    f"{nsamp / max(adec.rate, 1):.2f}s decoded",
                    file=sys.stderr,
                )
    except Exception as e:  # audio must never break video playback
        print(f"audio: undecodable ({e})", file=sys.stderr)

    dec = PacketDecoder(info, setup, device)
    if len(pkts) > 3:
        # Build the kernels and warm the decoder on a decoder of its own
        # before the clock starts, so that playback does not open by
        # dropping the frames decoded meanwhile.
        PacketDecoder(info, setup, device).decode_packet(pkts[3].data)
    out_f = open(args.output, "wb") if args.output else None
    if out_f:
        tag = {0: "C420jpeg", 2: "C422", 3: "C444"}[int(info.pixel_fmt)]
        out_f.write(
            f"YUV4MPEG2 W{info.pic_width} H{info.pic_height} "
            f"F{info.fps_numerator}:{info.fps_denominator} Ip A1:1 "
            f"{tag}\n".encode()
        )
    t_start = time.perf_counter()
    shown = dropped = 0
    late = 0.0
    quit_early = False
    for i, p in enumerate(pkts[3:]):
        # The audio clock paces when playing; wall clock otherwise
        # (player_example.c uses the audio buffer position the same way).
        aclk = disp.audio_clock() if disp else None
        t_due = t_start + i / fps
        dec.decode_packet(p.data)
        now = time.perf_counter()
        if aclk is not None:
            behind = aclk - i / fps
        else:
            behind = now - t_due
        if not args.stats_only:
            if behind > 1.0 / fps:
                dropped += 1   # behind by more than a frame: skip display
                late += behind
                continue
            if behind < 0:
                time.sleep(-behind)
        frame = dec.ycbcr_out()
        shown += 1
        x0, y0 = info.pic_x, info.pic_y
        w, h = info.pic_width, info.pic_height
        hd, vd = info.hdec, info.vdec
        if disp is not None:
            rgb = _yuv_to_rgb(
                frame[0][y0 : y0 + h, x0 : x0 + w],
                frame[1][y0 >> vd :, x0 >> hd :],
                frame[2][y0 >> vd :, x0 >> hd :],
                hd, vd,
            )
            disp.show(rgb)
            if not disp.pump():
                quit_early = True
                break
        if out_f:
            out_f.write(b"FRAME\n")
            out_f.write(frame[0][y0 : y0 + h, x0 : x0 + w].tobytes())
            for pli in (1, 2):
                out_f.write(
                    frame[pli][
                        y0 >> vd : (y0 + h) >> vd, x0 >> hd : (x0 + w) >> hd
                    ].tobytes()
                )
    dt = time.perf_counter() - t_start
    if out_f:
        out_f.close()
    if disp is not None:
        disp.close()
    n = len(pkts) - 3
    print(
        f"played {shown}/{n} frames in {dt:.2f}s "
        f"({n/dt:.1f} fps decode, {dropped} dropped"
        f"{', quit' if quit_early else ''}, "
        f"{late*1000/max(dropped,1):.0f} ms avg lateness)",
        file=sys.stderr,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
