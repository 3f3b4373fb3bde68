"""The benchmark of theora_tpu_torch: one cell, run once.

Usage (from the root of a checkout):
    python3 portbench/run.py --workload CELL --seed N --seconds S --trace 0|1

A cell (BENCHMARK.json's `workloads`) names a configuration
(portbench/configs/<config>.json: the stream's settings and sizes) and a
traffic mix (portbench/mixes/<traffic>.json: the entry, the sessions, the
clip's length, the decoder's batch, the sample the reference judges), so
that a new mix or configuration is a cell as soon as its files exist and
an entry names them. The comparison's limits are portbench/limits/<cell>.json, and each
per-layer metric is read by portbench/metrics/<metric>.py (or, for a
metric split by a suffix, <metric before the first dot>.py).

The run: build the port's nine libraries at once; start one worker per
session (worker.py), all on the one card, each with its clip from seed +
session; when all are set up, give them a common start; each runs whole
jobs back to back and starts none after --seconds have passed. The rate
is every frame of every completed job over the time from the common
start to the last job's end; setup_s runs from this process's start to
the common start. With --trace 1 each worker traces its second job and
the metrics are the cell's per-layer ones. After the window, the
reference decodes a seeded GOP of each session's output (judge.py, one process per
session) and the numbers it gives are held to their limits; together with
every job's output equalling its session's first, that decides `correct`.
Prints each number compared and its limit as the last lines on standard
error, and one JSON object as the last line on standard output.

Exits 2 with no result when no CUDA card is there (or fewer than the cell
asks for), and 3 when jax, jaxlib, flax or theora_tpu is loaded once the
window has closed, in this process or in any worker.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import queue  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import threading  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from yardstick import trace  # noqa: E402
from yardstick.kernels import kernel_of  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "theora_tpu")
READY_TIMEOUT_S = 900
JOB_TAIL_S = 300


def _load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def resolve(workload: str, root: str,
            mix_overrides: dict | None = None) -> dict:
    """The cell's configuration, mix (with the tests' overrides), limits,
    chips and metric lists, from the cell's entry in root's
    BENCHMARK.json."""
    bench = _load(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}")
    cell = cells[workload]
    cfg = _load(os.path.join(HERE, "configs", cell["config"] + ".json"))
    mix = {**_load(os.path.join(HERE, "mixes", cell["traffic"] + ".json")),
           **(mix_overrides or {})}
    in_cfg = (_load(os.path.join(HERE, "configs",
                                 mix["input_config"] + ".json"))
              if mix.get("input_config") else None)
    limits = _load(os.path.join(HERE, "limits", workload + ".json"))

    def applies(m):
        return workload in m.get("workloads", (workload,))

    return {"workload": workload, "config": cfg, "mix": mix,
            "input_config": in_cfg, "limits": limits,
            "chips": cell["chips"],
            "end_to_end": [m for m in bench["end_to_end"] if applies(m)],
            "per_layer": [m for m in bench["per_layer"] if applies(m)]}


def build_all(device: str) -> None:
    """Build the native host library and, on the card, the eight kernel
    libraries, all at once (each build is safe beside others)."""
    from theora_tpu_torch import native

    builds = [native.build]
    if device == "cuda":
        from theora_tpu_torch.ops import fdct_cuda, idct_cuda, \
            loopfilter_cuda, mc_cuda, me_cuda, postproc_cuda, qrd_cuda, \
            trellis_cuda
        builds += [m.build for m in (fdct_cuda, idct_cuda, loopfilter_cuda,
                                     mc_cuda, me_cuda, postproc_cuda,
                                     qrd_cuda, trellis_cuda)]
    errors = []

    def run(fn):
        try:
            fn()
        except Exception as e:  # reported below, after every build ends
            errors.append(e)

    threads = [threading.Thread(target=run, args=(fn,)) for fn in builds]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]


class Worker:
    """A worker process and a thread that reads its lines."""

    def __init__(self, root: str, env: dict):
        self.proc = subprocess.Popen(
            [sys.executable, os.path.join(HERE, "worker.py")],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
            cwd=root, env=env)
        self.lines: queue.Queue = queue.Queue()
        threading.Thread(target=self._read, daemon=True).start()

    def _read(self):
        for line in self.proc.stdout:
            self.lines.put(line)
        self.lines.put(None)

    def send(self, obj) -> None:
        self.proc.stdin.write(json.dumps(obj) + "\n")
        self.proc.stdin.flush()

    def recv(self, timeout: float) -> dict:
        line = self.lines.get(timeout=timeout)
        if line is None:
            raise RuntimeError(f"worker exited with {self.proc.wait()}")
        msg = json.loads(line)
        if "error" in msg and "bounds" not in msg:
            raise RuntimeError("worker failed:\n" + msg["error"])
        return msg

    def stop(self) -> None:
        try:
            self.proc.stdin.close()
        except OSError:
            pass
        try:
            self.proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()


def _reader(name: str):
    for fn in (name, name.split(".")[0]):
        path = os.path.join(HERE, "metrics", fn + ".py")
        if os.path.exists(path):
            spec = importlib.util.spec_from_file_location(
                "portbench_metric_" + fn.replace(".", "_"), path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    return None


def trace_context(results: list) -> dict | None:
    """The traced stretch common to every worker: its bounds, every
    worker's device operations and host scopes inside it."""
    traces = [r["trace"] for r in results]
    if not traces or any(t is None for t in traces):
        return None
    a = max(t["span"][0] for t in traces)
    b = min(t["span"][1] for t in traces)
    if b <= a:
        return None
    return {"stretch": [a, b],
            "device_ops": [op for t in traces
                           for op in trace.clip(t["device_ops"], a, b)],
            "scopes": [t["scopes"] for t in traces]}


def breakdown(tr: dict) -> dict:
    """The device operations that took most of the stretch, and its idle
    time by what the workers' hosts were doing (each worker's innermost
    theora.* scope at a gap's middle takes an equal share of the gap)."""
    ops: dict = {}
    for name, s, e in tr["device_ops"]:
        ops[name] = ops.get(name, 0.0) + (e - s)
    idle: dict = {}
    n = len(tr["scopes"])
    for s, e in trace.gaps(tr["device_ops"], *tr["stretch"]):
        mid = (s + e) / 2
        for scopes in tr["scopes"]:
            what = trace.innermost(scopes, mid) or "no theora scope"
            idle[what] = idle.get(what, 0.0) + (e - s) / n
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k[:120], v] for k, v in top],
            "idle_gaps": sorted(([k, v] for k, v in idle.items()),
                                key=lambda kv: -kv[1])[:10]}


def judge_all(results, cell, seed, sample_dir, root) -> list[dict]:
    """judge.py on every session's sample, one process each."""
    cfg = cell["input_config"] or cell["config"]
    cfg_path = os.path.join(sample_dir, "config.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "judge.py"), r["sample_path"],
         cfg_path, str(seed + k)], stdout=subprocess.PIPE, text=True,
        cwd=root) for k, r in enumerate(results)]
    out = []
    for p in procs:
        text, _ = p.communicate()
        if p.returncode != 0:
            out.append(None)
            continue
        out.append(json.loads(text.strip().splitlines()[-1]))
    return out


def tally(results: list, verdicts: list, limits: dict, t0: float) -> dict:
    """The window's arithmetic and the verdict. The window runs from the
    common start t0 to the end of the last job of any session, the jobs
    finished after --seconds included; the rate is every frame of every
    job completed without error over that window. A job
    fails when it raised, when its output differs from its session's first
    job's (whose sample the reference judged), or when that sample failed
    a limit; a session the reference could not judge fails every job.
    Numbers named *_max take the largest over the sessions, the others
    their sum."""
    jobs = [j for r in results for j in r["jobs"]]
    frames = sum(j["frames"] for j in jobs if "error" not in j)
    end = max((j["end"] for j in jobs), default=t0)
    window_s = end - t0
    rate = frames / window_s if window_s > 0 else 0.0
    failed = 0
    numbers: dict = {}
    for r, v in zip(results, verdicts):
        ok_jobs = [j for j in r["jobs"] if "error" not in j]
        first = ok_jobs[0]["digest"] if ok_jobs else None
        failed += sum(1 for j in r["jobs"]
                      if "error" in j or j["digest"] != first)
        if v is None:
            failed += sum(1 for j in ok_jobs if j["digest"] == first)
            continue
        for k, x in v.items():
            numbers[k] = (max(numbers.get(k, x), x) if k.endswith("_max")
                          else numbers.get(k, 0) + x)
        if any(x > limits.get(k, float("inf")) for k, x in v.items()):
            failed += sum(1 for j in ok_jobs if j["digest"] == first)
    checks = {k: {"value": numbers.get(k), "limit": lim}
              for k, lim in limits.items()}
    correct = (len(jobs) > 0 and failed == 0 and all(
        c["value"] is not None and c["value"] <= c["limit"]
        for c in checks.values()))
    return {"frames": frames, "window_s": window_s,
            "rate": rate,
            "attempted": len(jobs), "failed": failed, "checks": checks,
            "correct": correct}


def run_cell(workload: str, seed: int, seconds: float, traced: bool,
             device: str = "cuda", fault: str | None = None,
             mix_overrides: dict | None = None,
             keep_samples: str | None = None) -> tuple[int, dict | None]:
    """Run one cell once; (exit code, the result object or None). The
    tests run it on the CPU (device "cpu") with a fault planted or the mix
    changed; control.py keeps the sessions' samples (keep_samples, a
    directory) to judge them again in the control's precision."""
    root = os.getcwd()
    cell = resolve(workload, root, mix_overrides)
    mix = cell["mix"]
    if device == "cuda":
        import torch

        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < cell["chips"]:
            print(f"portbench: {workload} needs {cell['chips']} CUDA "
                  f"card(s); none is available", file=sys.stderr)
            return 2, None
    sys.path.insert(0, root)
    t = time.perf_counter()
    build_all(device)
    build_s = time.perf_counter() - t
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               USE_FLAX="0")
    sample_dir = tempfile.mkdtemp(prefix="portbench-")
    workers = []
    try:
        for k in range(int(mix["sessions"])):
            w = Worker(root, env)
            w.send({"root": root, "config": cell["config"], "mix": mix,
                    "input_config": cell["input_config"],
                    "seed": seed + k, "session": k, "trace": traced,
                    "device": device, "fault": fault,
                    "sample_dir": sample_dir})
            workers.append(w)
        splits = [w.recv(READY_TIMEOUT_S)["split"] for w in workers]
        t0 = time.perf_counter() + 0.5
        for w in workers:
            w.send({"t0": t0, "seconds": seconds})
        setup_s = t0 - T_START
        results = [w.recv(seconds + JOB_TAIL_S) for w in workers]
        bounds = None
        if traced:
            bounds = workers[0].recv(JOB_TAIL_S).get("bounds")
        # Each worker's last word: the forbidden top-level modules it
        # holds once its last job has run.
        held = sorted({m for w in workers
                       for m in w.recv(JOB_TAIL_S)["forbidden"]})
        for w in workers:
            w.stop()
        workers = []
        keys = sorted({k for s in splits for k in s})
        split = {"build_s": build_s, **{k: max(s.get(k, 0.0) for s in splits)
                                        for k in keys}}
        print("portbench: setup_s %.3f = %s (the slowest session's "
              "phases; the rest is process starts and waiting)" % (
                  setup_s, ", ".join(f"{k} {v:.3f}" for k, v in
                                     split.items())), file=sys.stderr)
        t = time.perf_counter()
        verdicts = judge_all(results, cell, seed, sample_dir, root)
        print("portbench: the reference judged %d sessions' samples in "
              "%.3f s" % (len(results), time.perf_counter() - t),
              file=sys.stderr)
        if keep_samples:
            shutil.copytree(sample_dir, keep_samples, dirs_exist_ok=True)
    finally:
        for w in workers:
            w.proc.kill()
            w.proc.wait()
        shutil.rmtree(sample_dir, ignore_errors=True)

    if held:
        print(f"portbench: a worker holds {held}", file=sys.stderr)
        return 3, None
    for r in results:
        for j in r["jobs"]:
            if "error" in j:
                print(j["error"], file=sys.stderr)
    t = tally(results, verdicts, cell["limits"], t0)
    for k, r in enumerate(results):
        if r.get("coded"):
            print("portbench: session %d's first job: %s" % (k, r["coded"]),
                  file=sys.stderr)
    print("portbench: jobs and last end per session: %s" % ", ".join(
        "%d / %.3f s" % (len(r["jobs"]), max((j["end"] for j in r["jobs"]),
                                            default=t0) - t0)
        for r in results), file=sys.stderr)
    frames, rate = t["frames"], t["rate"]
    checks = t["checks"]

    counters: dict = {}
    for r in results:
        for k, x in r["counters"].items():
            counters[k] = counters.get(k, 0) + x
    tr = trace_context(results) if traced else None
    # What a per-layer metric's reader (metrics/<name>.py) is given.
    ctx = {"frames": frames, "rate": rate, "counters": counters,
           "trace": tr, "bounds": bounds, "kernel_of": kernel_of}
    metrics = {}
    if traced:
        for m in cell["per_layer"]:
            read = _reader(m["name"])
            value = read(ctx) if read else None
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell["end_to_end"]:
            if m["name"] == "setup_s":
                value = setup_s
            elif m["name"] == mix["entry"] + "_fps":
                value = rate
            else:
                continue
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    dev = {"platform": "gpu" if device == "cuda" else "cpu",
           "kind": "cpu", "count": cell["chips"],
           "memory_peak_bytes": sum(r["memory_peak_bytes"]
                                    for r in results)}
    if device == "cuda":
        import torch

        dev["kind"] = torch.cuda.get_device_name(0)
        dev["power_limit"] = _power_limit()
    if traced and tr is not None:
        a, b = tr["stretch"]
        dev["busy_s"] = trace.busy_seconds(tr["device_ops"])
        dev["window_s"] = b - a
    result = {"correct": t["correct"], "attempted": t["attempted"],
              "failed": t["failed"],
              "metrics": metrics, "device": dev}
    if traced and tr is not None:
        result["breakdown"] = breakdown(tr)
    result["checks"] = checks

    loaded = forbidden_modules()
    if loaded:
        print(f"portbench: the harness's process holds {loaded}",
              file=sys.stderr)
        return 3, None
    for k, c in checks.items():
        print(f"check {k}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    return 0, result


def forbidden_modules() -> list[str]:
    """The forbidden top-level names among this process's modules,
    compared whole (theora_tpu_torch is not theora_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _power_limit() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].split(",")[-1].strip() if lines else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        import theora_tpu_torch  # noqa: F401
    except ImportError:
        sys.path.insert(0, os.getcwd())
        try:
            import theora_tpu_torch  # noqa: F401
        except ImportError as e:
            print(f"portbench: the port is not here: {e}", file=sys.stderr)
            return 2
    rc, result = run_cell(args.workload, args.seed, args.seconds,
                          bool(args.trace))
    if result is not None:
        print(json.dumps(result), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
