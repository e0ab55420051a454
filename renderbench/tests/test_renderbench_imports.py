"""Nothing the benchmark loads is JAX or the JAX package, compared by whole
top-level module names (the port's name begins with the JAX package's);
the reference loads nothing of the program either."""

import json
import subprocess
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
REPO = BENCH_DIR.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "zenith_tpu"}

PRELUDE = f"""
import json, sys, importlib.util, pathlib
sys.path[:0] = [{str(BENCH_DIR)!r}, {str(REPO)!r}]
def top():
    return sorted({{m.split('.')[0] for m in sys.modules}})
"""


def modules_after(body: str) -> "set[str]":
    out = subprocess.run([sys.executable, "-c", PRELUDE + body + "\nprint(json.dumps(top()))"],
                         cwd=REPO, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_loads_neither_jax_nor_the_program():
    loaded = modules_after("""
import reference
from reference import atmosphere, camera, deferred, raster, shade, sandbox, terrain
img, _, _ = reference.render_frame("terrain", ["--grid", "16"],
                                {"orbit_start": 0.5, "dt": 1 / 60, "width": 32, "height": 16},
                                2, "cpu")
assert img.shape == (16, 32, 4)
""")
    assert not loaded & FORBIDDEN
    assert "zenith_tpu_torch" not in loaded


def test_harness_metrics_and_tools_load_no_jax():
    loaded = modules_after("""
import harness, roofline, control
for path in sorted(pathlib.Path(harness.HERE, "metrics").glob("*.py")):
    harness.load_metric(path.stem)
import zenith_tpu_torch
from zenith_tpu_torch.sandbox import scene, terrain
from zenith_tpu_torch import engine, window, launch
""")
    assert not loaded & FORBIDDEN
    assert "zenith_tpu_torch" in loaded


def test_a_whole_small_run_loads_no_jax(tmp_path):
    loaded = modules_after(f"""
sys.path.insert(0, {str(BENCH_DIR / 'tests')!r})
import conftest, harness
result = conftest.run_small(pathlib.Path({str(tmp_path)!r}), "terrain.flyover", 5)
assert result["correct"], result
assert harness.forbidden_modules() == []
""")
    assert not loaded & FORBIDDEN


def test_the_forbidden_check_compares_whole_names():
    import harness

    sys.modules.setdefault("zenith_tpu_torch_probe_only", type(sys)("zenith_tpu_torch_probe_only"))
    try:
        assert "zenith_tpu_torch_probe_only" not in harness.forbidden_modules()
        sys.modules["jaxlib"] = type(sys)("jaxlib")
        assert "jaxlib" in harness.forbidden_modules()
    finally:
        sys.modules.pop("jaxlib", None)
        sys.modules.pop("zenith_tpu_torch_probe_only", None)
