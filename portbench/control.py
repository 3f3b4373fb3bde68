"""The comparison's control: the readings that set each limit's upper end.

Usage (from the root of a checkout, on the card):
    python3 portbench/control.py --workload CELL --seeds 11,12,13 [--seconds 1]

For each seed, runs the cell once as run.py does (a short window), keeps
every session's sample, and has the reference judge each twice: as the
benchmark does (the program's output: the lower readings), and in the
lower precision of the control (judge.py --control: the reference in the
program's place with its coefficients one bit coarser, or with a float
iDCT for the decode). Prints one JSON line per seed and session with both
readings. With --fault F the runs have the harness's planted fault F
(worker.py; "intra" codes every frame as a keyframe) and the lines hold
the program's readings only: the fault's readings, which a limit must
also stay below. The benchmark's own runs never run the control.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import run  # noqa: E402


def readings(workload: str, seeds: list[int], seconds: float,
             device: str = "cuda", mix_overrides: dict | None = None,
             fault: str | None = None):
    """[{seed, session, program: numbers, control: numbers}] (no control
    under a fault)."""
    cell = run.resolve(workload, os.getcwd(), mix_overrides)
    cfg = cell["input_config"] or cell["config"]
    out = []
    for seed in seeds:
        with tempfile.TemporaryDirectory(prefix="portbench-ctl-") as d:
            rc, res = run.run_cell(workload, seed, seconds, False,
                                   device=device, fault=fault,
                                   mix_overrides=mix_overrides,
                                   keep_samples=d)
            if rc != 0:
                raise SystemExit(f"run failed with {rc}")
            cfg_path = os.path.join(d, "config.json")
            with open(cfg_path, "w") as f:
                json.dump(cfg, f)
            sessions = sorted(n for n in os.listdir(d)
                              if n.startswith("session"))
            modes = (("program", []), ("control", ["--control"]))[
                :1 if fault else 2]
            # Every session's judges at once, one process each.
            procs = {(name, what): subprocess.Popen(
                [sys.executable, os.path.join(HERE, "judge.py"),
                 os.path.join(d, name), cfg_path,
                 str(seed + int(name[len("session"):-len(".pkl")])),
                 *extra], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True) for name in sessions for what, extra in modes}
            texts = {key: p.communicate() for key, p in procs.items()}
            for name in sessions:
                k = int(name[len("session"):-len(".pkl")])
                row = {"seed": seed, "session": k,
                       "correct": res["correct"]}
                for what, _ in modes:
                    if procs[name, what].returncode != 0:
                        raise RuntimeError(texts[name, what][1])
                    row[what] = json.loads(
                        texts[name, what][0].strip().splitlines()[-1])
                out.append(row)
                print(json.dumps(row), flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--fault")
    args = ap.parse_args(argv)
    readings(args.workload, [int(s) for s in args.seeds.split(",")],
             args.seconds, fault=args.fault)
    return 0


if __name__ == "__main__":
    sys.exit(main())
