"""Paths and the card marker for the benchmark's own tests.

Run from the root of the repository: python -m pytest portbench/tests -q
(the repository's tier-1 run collects tests/ only). The tests run the
harness on the CPU at the 64x48 test configuration; a test that needs
the card carries the `cuda` marker and skips from a fixture."""
import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PORTBENCH = os.path.join(ROOT, "portbench")
for p in (PORTBENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA card; skips with a reason where none is present")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


TEST_CELLS = {"encode": "test64x48.encode", "decode": "test64x48.decode",
              "transcode": "test64x48.transcode"}


def bench_with(cells: dict[str, str]) -> dict:
    """BENCHMARK.json with more cells ({cell: entry}), each on the
    test64x48 configuration and the mix its name ends in, reporting the
    rate of its entry and setup_s."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for name, entry in cells.items():
        config, traffic = name.split(".", 1)
        bench["workloads"].append({"name": name, "config": config,
                                   "traffic": traffic, "chips": 1,
                                   "why": "a CPU test cell"})
        rate = e2e.setdefault(entry + "_fps", {
            "name": entry + "_fps", "unit": "frames/s", "better": "higher",
            "bound": 0.25, "source": "host_clock", "workloads": []})
        if "workloads" in rate:
            rate["workloads"].append(name)
    bench["end_to_end"] = list(e2e.values())
    return bench


def checkout_at(path, cells: dict[str, str], portbench=PORTBENCH):
    """A checkout at path: BENCHMARK.json with the cells added, and
    portbench/ and the port linked in."""
    with open(os.path.join(path, "BENCHMARK.json"), "w") as f:
        json.dump(bench_with(cells), f)
    if not os.path.exists(os.path.join(path, "portbench")):
        os.symlink(portbench, os.path.join(path, "portbench"))
    os.symlink(os.path.join(ROOT, "theora_tpu_torch"),
               os.path.join(path, "theora_tpu_torch"))
    return str(path)


@pytest.fixture(scope="session")
def test_root(tmp_path_factory):
    """A checkout whose BENCHMARK.json also holds the test64x48 cells."""
    return checkout_at(tmp_path_factory.mktemp("checkout"),
                       {name: entry for entry, name in TEST_CELLS.items()})


@pytest.fixture
def at_root(monkeypatch, test_root):
    """The harness runs from the root of that checkout."""
    monkeypatch.chdir(test_root)
    return test_root
