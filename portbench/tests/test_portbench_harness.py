"""The harness: cells resolve to their files, names and units keep to
BENCHMARK.json's rules, a CPU run of each mix is correct with the result
line's keys, planted faults make it incorrect, the control fails its
limits, the window's arithmetic, the import guard, and a new mix
becoming a cell."""
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

import run
from conftest import PORTBENCH, ROOT, TEST_CELLS, checkout_at

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SMALL = {"clip_frames": 16, "sessions": 2, "sample_frames": 8}
EXTRA = {"encode": {}, "decode": {},
         "transcode": {"input_config": "test64x48"}}


def _small(entry):
    return {**SMALL, **EXTRA[entry]}


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _cells():
    return [w["name"] for w in _bench()["workloads"]]


@pytest.mark.parametrize("workload", _cells())
def test_cell_resolves_to_its_files(workload):
    cell = run.resolve(workload, ROOT)
    assert cell["mix"]["entry"] in ("encode", "decode", "transcode")
    assert cell["config"]["name"] == workload.split(".")[0]
    assert cell["limits"]
    assert {m["name"] for m in cell["end_to_end"]} == {
        "setup_s", cell["mix"]["entry"] + "_fps"}
    for m in cell["per_layer"]:
        assert run._reader(m["name"]) is not None, m["name"]


def test_names_and_units_keep_to_the_rules():
    bench = _bench()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in bench[group]:
            assert NAME.match(entry["name"]), entry["name"]
            assert entry["name"] not in names
            names.add(entry["name"])
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
            for key in ("why", "layer", "source"):
                if key in entry:
                    assert 1 <= len(entry[key]) <= 200
                    assert "\n" not in entry[key] and "\t" not in entry[key]
    for c in bench["configs"]:
        assert c["file"].startswith("portbench/")
        assert os.path.exists(os.path.join(ROOT, c["file"]))
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1


@pytest.mark.parametrize("entry", sorted(TEST_CELLS))
def test_cpu_run_is_correct_with_the_result_keys(entry, at_root):
    rc, res = run.run_cell(TEST_CELLS[entry], 2**31 + 11, 1.0, False,
                           device="cpu", mix_overrides=_small(entry))
    assert rc == 0
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 2
    assert set(res["metrics"]) == {entry + "_fps", "setup_s"}
    for m in res["metrics"].values():
        assert m["value"] > 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        res["device"])
    for c in res["checks"].values():
        assert c["value"] <= c["limit"]


FAULTS = [(entry, fault) for entry in sorted(TEST_CELLS)
          for fault in ("alter", "half", "stale")
          + (("intra",) if entry != "decode" else ())]


@pytest.mark.parametrize("entry,fault", FAULTS)
def test_planted_fault_makes_the_run_incorrect(entry, fault, at_root):
    """A byte altered where it is produced (a packet of the sample, or a
    decoded plane), half of the output left out, a step that leaves its
    state as it was, every frame coded intra (an encoder that never
    predicts): each makes `correct` false."""
    rc, res = run.run_cell(TEST_CELLS[entry], 5, 0.5, False, device="cpu",
                           fault=fault, mix_overrides=_small(entry))
    assert rc == 0
    assert res["correct"] is False
    assert res["failed"] > 0


def test_a_worker_that_holds_jax_is_refused(at_root, capfd):
    """A worker that has a module named jax once its jobs have run makes
    the run exit 3 with no result, naming what it found."""
    rc, res = run.run_cell(TEST_CELLS["encode"], 6, 0.5, False,
                           device="cpu", fault="jax",
                           mix_overrides=_small("encode"))
    assert rc == 3 and res is None
    assert "['jax']" in capfd.readouterr().err


@pytest.mark.parametrize("entry", sorted(TEST_CELLS))
def test_control_fails_the_limits(entry, at_root):
    import control

    workload = TEST_CELLS[entry]
    rows = control.readings(workload, [3], 0.5, device="cpu",
                            mix_overrides=_small(entry))
    limits = run.resolve(workload, at_root)["limits"]
    for row in rows:
        assert all(row["program"][k] <= lim for k, lim in limits.items())
        assert any(row["control"][k] > lim for k, lim in limits.items())


def _job(start, end, frames=10, digest="a"):
    return {"start": start, "end": end, "frames": frames, "digest": digest}


def test_the_window_runs_from_the_common_start_to_the_last_job():
    """All frames over the common start to the last completion, the jobs
    finished after --seconds counted."""
    t0 = 100.0
    results = [{"jobs": [_job(100.0, 104.0), _job(104.0, 108.5),
                         _job(108.5, 113.0)]},
               {"jobs": [_job(100.0, 105.0), _job(105.0, 111.0)]}]
    verdicts = [{"bad_packets": 0, "mse_max": 2.0},
                {"bad_packets": 0, "mse_max": 3.0}]
    t = run.tally(results, verdicts, {"bad_packets": 0, "mse_max": 5.0}, t0)
    assert t["frames"] == 50
    assert t["window_s"] == pytest.approx(13.0)
    assert t["rate"] == pytest.approx(50 / 13.0)
    assert t["attempted"] == 5 and t["failed"] == 0 and t["correct"]
    assert t["checks"]["mse_max"]["value"] == 3.0


def test_a_job_that_differs_or_raises_fails():
    results = [{"jobs": [_job(0.0, 1.0), _job(1.0, 2.0, digest="b"),
                         {"start": 2.0, "end": 2.5, "frames": 0,
                          "error": "boom"}]}]
    t = run.tally(results, [{"mismatched_bytes": 0}],
                  {"mismatched_bytes": 0}, 0.0)
    assert t["failed"] == 2 and not t["correct"]
    assert t["frames"] == 20 and t["window_s"] == pytest.approx(2.5)
    assert t["rate"] == pytest.approx(20 / 2.5)


def test_a_sample_over_its_limit_fails_its_sessions_jobs():
    results = [{"jobs": [_job(0.0, 1.0), _job(1.0, 2.0)]},
               {"jobs": [_job(0.0, 1.5)]}]
    t = run.tally(results, [{"mismatched_bytes": 3}, None],
                  {"mismatched_bytes": 0}, 0.0)
    assert t["failed"] == 3
    assert not t["correct"]


def test_no_jax_and_no_port_in_the_reference(at_root):
    """After a harness run and a reference run no module in sys.modules
    has the top-level name jax or theora_tpu (compared whole:
    theora_tpu_torch begins with theora_tpu): in the harness's process
    here, and in each worker, whose own report the run's exit code 0
    shows; the reference's modules bring in no theora_tpu_torch."""
    code = (
        "import sys, json\n"
        "sys.path.insert(0, 'portbench')\n"
        "import run\n"
        "rc, res = run.run_cell('test64x48.encode', 9, 0.5, False, "
        "device='cpu', mix_overrides=%r)\n"
        "assert rc == 0 and res['correct']\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n"
        % SMALL)
    top = json.loads(subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        check=True, cwd=at_root).stdout.strip().splitlines()[-1])
    assert "jax" not in top and "theora_tpu" not in top
    assert "theora_tpu_torch" in top
    code = ("import sys, json\nsys.path.insert(0, 'portbench')\n"
            "import judge, reference.decoder, synth\n"
            "print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))\n")
    top = json.loads(subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        check=True, cwd=ROOT).stdout.strip().splitlines()[-1])
    assert not {"jax", "theora_tpu", "theora_tpu_torch"} & set(top)


def test_a_new_mix_file_is_a_runnable_cell(tmp_path):
    """A mix and its limits, added as files, and a cell, added as an entry
    of BENCHMARK.json, run with no file of the harness edited."""
    copy = tmp_path / "portbench"
    shutil.copytree(PORTBENCH, copy,
                    ignore=shutil.ignore_patterns("__pycache__"))
    (copy / "mixes" / "encode_one.json").write_text(json.dumps(
        {"entry": "encode", "what": "one session", "sessions": 1,
         "clip_frames": 8, "sample_frames": 4}))
    (copy / "limits" / "test64x48.encode_one.json").write_text(json.dumps(
        {"bad_packets": 0, "mse_max": 40.0, "kbit_per_frame_max": 40.0}))
    checkout_at(tmp_path, {"test64x48.encode_one": "encode"})
    code = ("import sys, json\nsys.path.insert(0, 'portbench')\nimport run\n"
            "rc, res = run.run_cell('test64x48.encode_one', 4, 0.5, False, "
            "device='cpu')\nprint(json.dumps(res))\n")
    res = json.loads(subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        check=True, cwd=tmp_path).stdout.strip().splitlines()[-1])
    assert res["correct"] is True
    assert res["metrics"]["encode_fps"]["value"] > 0


def test_only_cells_of_benchmark_json_run(at_root):
    with pytest.raises(SystemExit, match="unknown workload"):
        run.resolve("test64x48.encode_one", at_root)


def test_no_card_exits_nonzero_with_no_result(at_root):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "hd720_q48_k64.encode", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=ROOT)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_without_the_port_the_benchmark_fails(tmp_path):
    """In a directory that holds only BENCHMARK.json and portbench/, the
    command exits non-zero and prints no result."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(PORTBENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "hd720_q48_k64.encode", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=tmp_path,
        env=env)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


@pytest.mark.cuda
def test_each_cell_is_correct_on_the_card(card, at_root):
    for workload in _cells():
        proc = subprocess.run(
            [sys.executable, "portbench/run.py", "--workload", workload,
             "--seed", "20261028", "--seconds", "5", "--trace", "0"],
            capture_output=True, text=True, cwd=ROOT, timeout=1200)
        assert proc.returncode == 0, proc.stderr[-2000:]
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        assert res["correct"] is True, res["checks"]
