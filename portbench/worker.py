"""One session of a cell, in a process of its own.

The harness (run.py) starts one worker per session and talks to it over
its standard input and output, one JSON object per line; whatever the
program prints goes to standard error. The worker

1. reads its spec: the configuration, the mix, its session index and
   seed, the device, whether it traces, and a directory for its samples;
2. sets up: imports, synthesises its clip, makes the input stream where
   the entry decodes or transcodes, builds its encoder or decoder and
   warms it with one whole job; then reports "ready" with the set-up's
   split;
3. waits for "go" (the window's common start on the host's monotonic
   clock and its length), runs whole jobs back to back from that start,
   and starts none once the window has passed; with tracing on, its
   second job runs under torch.profiler;
4. reports each job (start, end, frames, digest of its output), the
   program's counters summed over the window, its memory peak, the
   traced device operations and host scopes, and writes the first job's
   sampled output for the reference (judge.py). With tracing on, session
   0 then runs one more job with the yardstick's bound recorders and
   reports the bounds;
5. last, reports the forbidden top-level modules (jax, jaxlib, flax,
   theora_tpu) it holds, which the harness refuses.
"""
from __future__ import annotations

import hashlib
import json
import os
import pickle
import sys
import time
import traceback
import types

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))


def info_of(cfg: dict):
    from theora_tpu_torch.info import TheoraInfo

    w, h = cfg["width"], cfg["height"]
    kf = int(cfg["keyframe_freq"])
    return TheoraInfo(frame_width=w, frame_height=h, pic_width=w,
                      pic_height=h, fps_numerator=cfg["fps"][0],
                      fps_denominator=cfg["fps"][1],
                      pixel_fmt=cfg["pixel_fmt"], quality=cfg["quality"],
                      target_bitrate=cfg["target_bitrate"],
                      keyframe_granule_shift=max(6, (kf - 1).bit_length()))


def encoder_of(cfg: dict, device: str):
    from theora_tpu_torch.encode.gop import GopEncoder

    enc = GopEncoder(info_of(cfg), qi=cfg["start_qi"],
                     adaptive_quant=cfg["adaptive_quant"], device=device)
    enc.set_splevel(cfg["speed_level"])
    return enc


def encode(enc, cfg: dict, frames, keyframe_freq=None) -> list[bytes]:
    """One encode job: the clip's headers and data packets."""
    enc.set_qi(cfg["start_qi"])
    pkts = enc.encode_clip(frames,
                           keyframe_freq=keyframe_freq or cfg["keyframe_freq"],
                           target_bitrate=cfg["target_bitrate"],
                           rate_window=cfg["rate_window"],
                           clip_batch=cfg["clip_batch"])
    return [p.data for p in pkts]


def sample_of(mix: dict, cfg: dict, in_cfg: dict, seed: int) -> list[int]:
    """The frames of the session's output the reference judges: the first
    sample_frames frames of one GOP drawn from the seed (a GOP of the
    stream the entry decodes, where it decodes)."""
    kf = int(in_cfg["keyframe_freq"] if mix["entry"] == "decode"
             else cfg["keyframe_freq"])
    n = int(mix["clip_frames"])
    g = int(np.random.default_rng([seed, 7]).integers(0, -(-n // kf)))
    first = g * kf
    return list(range(first, min(first + int(mix["sample_frames"]), n)))


def coded(cfg: dict, packets: list[bytes]) -> str:
    """What a job coded, for the log: the range of the frames' first qi
    (the low six bits of a data packet's first byte) and the bit rate."""
    qis = [d[0] & 0x3F for d in packets if d]
    fps = cfg["fps"][0] / cfg["fps"][1]
    kbit = 8e-3 * sum(len(d) for d in packets) * fps / max(len(packets), 1)
    return "qi %s-%s, %.1f kbit/s" % (min(qis, default=None),
                                      max(qis, default=None), kbit)


class Session:
    """The entry's set-up and its job; job() returns (frames, digest, the
    sampled output, what the job coded or None)."""

    def __init__(self, spec: dict, split: dict):
        from synth import Clip

        cfg, mix = spec["config"], spec["mix"]
        self.cfg, self.mix = cfg, mix
        self.entry = mix["entry"]
        self.device = dev = spec["device"]
        self.fault = spec.get("fault")
        in_cfg = spec.get("input_config") or cfg
        self.sample = sample_of(mix, cfg, in_cfg, spec["seed"])
        n = int(mix["clip_frames"])
        t = time.perf_counter()
        clip = Clip(in_cfg["width"], in_cfg["height"], spec["seed"])
        frames = clip.frames(n)
        split["synthesis_s"] = time.perf_counter() - t
        t = time.perf_counter()
        self.enc = self.dec = None
        if self.entry == "encode":
            self.frames = frames
            self.enc = encoder_of(cfg, dev)
        elif self.entry in ("decode", "transcode"):
            from theora_tpu_torch.headers import parse_info_header, \
                parse_setup_header

            stream = encode(encoder_of(in_cfg, dev), in_cfg, frames)
            self.headers, self.data = stream[:3], stream[3:]
            self.info = parse_info_header(self.headers[0])
            self.setup = parse_setup_header(self.headers[2])
            if self.entry == "decode":
                from theora_tpu_torch.decode.batch import BatchDecoder

                self.dec = BatchDecoder(self.info, self.setup, device=dev)
                self.dec.set_pplevel(int(mix.get("pp_level", 0)))
        else:
            raise ValueError(f"unknown entry {self.entry!r}")
        split["input_stream_s"] = time.perf_counter() - t

    def job(self):
        cfg, mix, s = self.cfg, self.mix, self.sample
        # The "intra" fault codes every frame as a keyframe, as a mode
        # decision that never predicts would.
        kf = 1 if self.fault == "intra" else cfg["keyframe_freq"]
        if self.fault == "jax":
            sys.modules.setdefault("jax", types.ModuleType("jax"))
        if self.entry == "encode":
            out = encode(self.enc, cfg, self.frames, kf)
        elif self.entry == "transcode":
            from theora_tpu_torch.encode.gop import transcode_device

            pkts = transcode_device(
                self.info, self.setup, self.data,
                keyframe_freq=kf, qi=cfg["start_qi"],
                target_bitrate=cfg["target_bitrate"],
                rate_window=cfg["rate_window"],
                enc_kwargs={"device": self.device,
                            "adaptive_quant": cfg["adaptive_quant"]})
            out = [p.data for p in pkts]
        else:
            frames = self.dec.decode_clip(self.data,
                                          batch=int(mix["batch"]))
            out = self._faulty([frames[i] if i < len(frames) else None
                                for i in s])
            nframes = len(frames)
            h = hashlib.sha256()
            for fr in out:
                for p in fr or ():
                    h.update(np.ascontiguousarray(p).tobytes())
            return nframes, h.hexdigest(), out, None
        out = self._faulty(out)
        h = hashlib.sha256()
        for d in out:
            h.update(len(d).to_bytes(4, "little") + d)
        nframes = len(out) - 3
        sampled = out[:3] + [out[3 + i] for i in s if 3 + i < len(out)]
        return nframes, h.hexdigest(), sampled, coded(cfg, out[3:])

    def _faulty(self, out):
        """The job's output with the test's planted fault, if any: a byte
        altered where it is produced ("alter"), half of the output left
        out ("half"), or every frame after the first of the sample left
        as the first ("stale"). Used by the harness's tests only."""
        f = self.fault
        if f is None:
            return out
        out = list(out)
        if self.entry == "decode":
            if f == "alter":
                out[1] = [p.copy() for p in out[1]]
                out[1][0][3, 5] ^= 0x10
            elif f == "half":
                out = out[:len(out) // 2]
            elif f == "stale":
                out = [out[0]] * len(out)
            return out
        body = out[3:]
        pick = 3 + self.sample[1]
        if f == "alter":
            d = bytearray(out[pick])
            d[len(d) // 2] ^= 0x10
            out[pick] = bytes(d)
        elif f == "half":
            out = out[:3] + body[:len(body) // 2]
        elif f == "stale":
            out = out[:3] + [body[0]] + [b""] * (len(body) - 1)
        return out

    def counters(self) -> dict:
        out = {}
        if self.enc is not None:
            for k in ("host_decide_s", "host_pack_s"):
                out[k] = getattr(self.enc, k, None)
        if self.dec is not None:
            out["host_parse_s"] = getattr(self.dec, "host_parse_s", None)
        return {k: v for k, v in out.items() if v is not None}

    def reset_counters(self) -> None:
        for obj, keys in ((self.enc, ("host_decide_s", "host_pack_s")),
                          (self.dec, ("host_parse_s",))):
            for k in keys if obj is not None else ():
                if hasattr(obj, k):
                    setattr(obj, k, type(getattr(obj, k))(0))


def _sync(device: str) -> None:
    import torch

    if device == "cuda":
        torch.cuda.synchronize()


def traced_job(sess):
    """One job under torch.profiler: (its result, device ops, host
    scopes, [start, end] of the trace), times on the monotonic clock."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from yardstick import trace

    acts = [ProfilerActivity.CPU]
    if sess.device == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    _sync(sess.device)
    prof.start()
    with record_function("portbench.mark"):
        t_mark = time.perf_counter()
    t0 = time.perf_counter()
    res = sess.job()
    _sync(sess.device)
    t1 = time.perf_counter()
    prof.stop()
    events = prof.events()
    mark = next(e for e in events if e.name == "portbench.mark")
    offset = t_mark - mark.time_range.start / 1e6
    return (res, trace.device_intervals(events, offset),
            trace.host_scopes(events, offset), [t0, t1])


def main() -> int:
    t_proc = time.perf_counter()
    proto = os.fdopen(os.dup(1), "w")
    os.dup2(2, 1)  # the program's prints go to standard error

    def send(obj):
        proto.write(json.dumps(obj) + "\n")
        proto.flush()

    spec = json.loads(sys.stdin.readline())
    sys.path.insert(0, spec["root"])
    split = {}
    try:
        import torch

        torch.set_num_threads(1)
        import theora_tpu_torch.decode.batch  # noqa: F401
        import theora_tpu_torch.encode.gop  # noqa: F401
        split["import_s"] = time.perf_counter() - t_proc
        sess = Session(spec, split)
        t = time.perf_counter()
        sess.job()
        if spec["trace"]:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if sess.device == "cuda" else [])
            with profile(activities=acts):
                torch.zeros(1, device=sess.device).add_(1)
        _sync(sess.device)
        split["warmup_s"] = time.perf_counter() - t
    except Exception:
        send({"error": traceback.format_exc()})
        return 1
    send({"ready": True, "split": split})

    go = json.loads(sys.stdin.readline())
    t0, t_end = go["t0"], go["t0"] + go["seconds"]
    sess.reset_counters()
    if sess.device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    while time.perf_counter() < t0:
        time.sleep(min(0.01, max(t0 - time.perf_counter(), 0)))
    jobs, first_sample, first_coded, traced = [], None, None, None
    while time.perf_counter() < t_end:
        start = time.perf_counter()
        try:
            if spec["trace"] and len(jobs) == 1:
                res, ops, scopes, span = traced_job(sess)
                traced = {"device_ops": ops, "scopes": scopes, "span": span}
            else:
                res = sess.job()
                _sync(sess.device)
        except Exception:
            jobs.append({"start": start, "end": time.perf_counter(),
                         "frames": 0, "error": traceback.format_exc()})
            continue
        nframes, digest, sampled, what = res
        jobs.append({"start": start, "end": time.perf_counter(),
                     "frames": nframes, "digest": digest})
        if first_sample is None:
            first_sample, first_coded = sampled, what
    counters = sess.counters()
    peak = (torch.cuda.max_memory_reserved() if sess.device == "cuda"
            else 0)
    sample_path = os.path.join(spec["sample_dir"],
                               f"session{spec['session']}.pkl")
    with open(sample_path, "wb") as f:
        pickle.dump({"entry": sess.entry, "sample": sess.sample,
                     "output": first_sample,
                     "headers": getattr(sess, "headers", None),
                     "input": (None if sess.entry != "decode" else
                               [sess.data[i] for i in
                                range(sess.sample[0], sess.sample[-1] + 1)]),
                     }, f, protocol=pickle.HIGHEST_PROTOCOL)
    send({"jobs": jobs, "counters": counters, "memory_peak_bytes": peak,
          "trace": traced, "sample_path": sample_path,
          "coded": first_coded})
    if spec["trace"] and spec["session"] == 0:
        from yardstick.kernels import record_bounds

        try:
            send({"bounds": record_bounds(sess.job)})
        except Exception:
            send({"bounds": None, "error": traceback.format_exc()})
    from run import forbidden_modules

    send({"forbidden": forbidden_modules()})
    return 0


if __name__ == "__main__":
    sys.path.insert(0, _HERE)
    sys.exit(main())
