"""Shared set-up of the benchmark's own tests: the harness's folder on the
import path, the ``card`` marker, and small copies of the cells that a CPU
test run can hold."""

import json
import os
import shutil
import sys
from pathlib import Path

import pytest

BENCH_DIR = Path(__file__).resolve().parents[1]
REPO = BENCH_DIR.parent
for p in (str(BENCH_DIR), str(REPO)):
    if p not in sys.path:
        sys.path.insert(0, p)

# Small stand-ins of each cell: the same scene code and flags at a size a
# CPU run holds in seconds. A cell that BENCHMARK.json does not hold (yet)
# names its configuration and traffic here.
SMALL = {
    "scene.instanced30": {"width": 160, "height": 96,
                          "app_args": ["--gun-instances", "2", "--instances", "4"],
                          "config": "sandbox_scene", "traffic": "instanced30"},
    "terrain.flyover": {"width": 160, "height": 96, "app_args": ["--grid", "64"]},
    "scene.ibl": {"width": 160, "height": 96,
                  "app_args": ["--ibl", "--fxaa", "--grade", "--film", "--auto-exposure"]},
}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skipped without one")


@pytest.fixture
def card():
    """Skips the test where no CUDA device is present."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the H100 the benchmark runs on)")
    return torch.device("cuda", 0)


def small_root(tmp: Path, cell: str) -> Path:
    """A copy of BENCHMARK.json and the harness's data folders under
    ``tmp`` with ``cell``'s configuration and traffic cut to SMALL (one
    warm-up frame, two judged frames)."""
    root = Path(tmp) / "root"
    shutil.copytree(BENCH_DIR, root / "renderbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    if cell not in [w["name"] for w in bench["workloads"]]:
        bench["workloads"].append({"name": cell, "config": SMALL[cell]["config"],
                                   "traffic": SMALL[cell]["traffic"], "chips": 1, "why": cell})
        (root / "BENCHMARK.json").write_text(json.dumps(bench))
    entry = next(w for w in bench["workloads"] if w["name"] == cell)
    cfg_file = next(c["file"] for c in bench["configs"] if c["name"] == entry["config"])
    cfg = json.loads((root / cfg_file).read_text())
    cfg["width"], cfg["height"] = SMALL[cell]["width"], SMALL[cell]["height"]
    (root / cfg_file).write_text(json.dumps(cfg))
    tpath = root / "renderbench" / "traffic" / f"{entry['traffic']}.json"
    traffic = json.loads(tpath.read_text())
    traffic.update({"app_args": SMALL[cell]["app_args"], "warmup_frames": 1,
                    "judged_frames": 2})
    tpath.write_text(json.dumps(traffic))
    return root


def run_small(tmp: Path, cell: str, seed: int, break_program=None, monkeypatch=None):
    """One run of the small ``cell`` on the CPU, the chip check skipped."""
    import argparse

    import harness

    root = small_root(tmp, cell)
    if monkeypatch is not None:
        monkeypatch.chdir(REPO)
    else:
        os.chdir(REPO)
    args = argparse.Namespace(workload=cell, seed=seed, seconds=0.01, trace=0)
    return harness.run(args, 0.0, 0.0, root, device="cpu", chip_check=False,
                       break_program=break_program, data=root / "renderbench")
