"""A new cell, scene or per-layer metric is new files: the harness lists and
loads a cell file and a metric file added to a copy of its data folders
without any existing file being edited."""

import json
import shutil
from pathlib import Path

import harness

BENCH_DIR = Path(__file__).resolve().parents[1]
REPO = BENCH_DIR.parent


def test_added_cell_and_metric_are_found_by_name(tmp_path):
    root = tmp_path / "root"
    data = root / "renderbench"
    for folder in ("configs", "traffic", "cells", "metrics"):
        shutil.copytree(BENCH_DIR / folder, data / folder)
    before = {p: p.read_bytes() for p in data.rglob("*") if p.is_file()}
    bench = json.loads((REPO / "BENCHMARK.json").read_text())

    # The new cell: a traffic mix of its own over an existing scene, and
    # its check file.
    (data / "traffic" / "lights300.json").write_text(json.dumps(
        {"why": "three times the point lights", "app_args": ["--lights", "300"],
         "warmup_frames": 4, "judged_frames": 2}))
    (data / "cells" / "scene.lights300.json").write_text(json.dumps(
        {"limits": {"off_pct": 0.75, "mean_lsb": 0.1}}))
    (data / "metrics" / "k1_launches.py").write_text(
        "def read(trace):\n"
        "    n = sum('raster_segmented_kernel' in k[0] for k in trace['kernels'])\n"
        "    return n / trace['frames'] if n else None\n")
    bench["workloads"].append({"name": "scene.lights300", "config": "sandbox_scene",
                               "traffic": "lights300", "chips": 1, "why": "K2 at 300 lights"})
    bench["per_layer"].append({"name": "k1_launches", "unit": "launches/frame",
                               "better": "lower", "source": "device_trace",
                               "layer": "kernels", "moves": "fps",
                               "workloads": ["scene.lights300"]})
    # The configuration files are named by BENCHMARK.json relative to the root.
    shutil.copytree(BENCH_DIR / "configs", root / "renderbench" / "configs",
                    dirs_exist_ok=True)

    spec = harness.cell_spec(bench, "scene.lights300", root, data)
    assert spec["traffic"]["app_args"] == ["--lights", "300"]
    assert spec["checks"]["limits"]["off_pct"] == 0.75
    assert spec["config"]["app"].endswith(":SceneApp")
    names = [m["name"] for m in spec["per_layer"]]
    assert "k1_launches" in names and "k2_roofline_pct" not in names
    argv, inputs = harness.seeded_inputs(spec, 2 ** 31 + 7)
    assert argv[-2:] == ["--lights", "300"] and inputs["width"] == 1920
    read = harness.load_metric("k1_launches", data)
    trace = {"frames": 2, "kernels": [("raster_segmented_kernel<0>", 0, 1)] * 12}
    assert read(trace) == 6
    assert harness.load_metric("k1_launches", data)({"frames": 2, "kernels": []}) is None
    # Every file that was there is unchanged.
    assert all(p.read_bytes() == b for p, b in before.items())
    other = harness.cell_spec(bench, "terrain.flyover", root, data)
    assert "k1_launches" not in [m["name"] for m in other["per_layer"]]


def test_every_declared_metric_and_cell_has_its_files():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        assert (BENCH_DIR / "metrics" / f"{m['name']}.py").is_file(), m["name"]
    for w in bench["workloads"]:
        spec = harness.cell_spec(bench, w["name"], REPO)
        assert spec["checks"]["limits"], w["name"]
        assert (BENCH_DIR / "reference" / f"{spec['config']['reference']}.py").is_file()
