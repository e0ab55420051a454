"""The render benchmark's harness: one run of one cell.

A cell (an entry of ``workloads`` in BENCHMARK.json) names a configuration
(``configs/<name>.json``: the app, its flags, the frame size, the reference
scene) and a traffic mix (``traffic/<name>.json``: the flags that set what
each frame draws, how the seed reaches the scene, the warm-up and the
traced and judged frames); ``cells/<cell>.json`` holds the limits of its
correctness check. Per-layer metrics are read by ``metrics/<name>.py``.
Everything is found by name, so a new cell, scene or metric is new files.

A run: set-up (import, scene, kernels, warm-up frames), then frames for
``--seconds`` with a fixed dt of 1/60 s, each frame ``engine.tick``,
``app.tick``, ``engine.render`` and the window's present, as the port's
engine loop runs them; with ``--trace 1`` a few profiled frames and one
recorded frame instead. Then the peak memory is read, the program freed,
and a sample of the presented frames, drawn from the seed, is compared
with the plain reference. The last line of standard output is the result.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import math
import os
import sys
import time
from contextlib import contextmanager, nullcontext
from pathlib import Path
from unittest import mock

import numpy as np

HERE = Path(__file__).resolve().parent
DT = 1.0 / 60.0
FORBIDDEN = ("jax", "jaxlib", "flax", "zenith_tpu")
# What a judged frame that was never presented reads.
MISSING = {"off_pct": 100.0, "mean_lsb": 255.0, "exposure_rel": 1.0}


class Fail(Exception):
    """A run that prints no result: the message goes to standard error."""


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find_benchmark(root: Path) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise Fail(f"no BENCHMARK.json in {root}")
    return load_json(path)


def cell_spec(bench: dict, name: str, root: Path, data: Path = HERE) -> dict:
    """Everything one cell runs with: its BENCHMARK.json entry, its
    configuration, traffic and check files, and its metrics. Paths in
    BENCHMARK.json are relative to ``root``; the traffic, check and metric
    files are found by name under ``data``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise Fail(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}

    def applies(m):
        return "workloads" not in m or name in m["workloads"]

    return {
        "cell": cell,
        "config": load_json(Path(root) / configs[cell["config"]]["file"]),
        "traffic": load_json(Path(data) / "traffic" / f"{cell['traffic']}.json"),
        "checks": load_json(Path(data) / "cells" / f"{name}.json"),
        "end_to_end": [m for m in bench["end_to_end"] if applies(m)],
        "per_layer": [m for m in bench["per_layer"] if applies(m)],
        "data": Path(data),
    }


def load_metric(name: str, data: Path = HERE):
    """The reader of per-layer metric ``name``: ``metrics/<name>.py``'s
    ``read(trace)``."""
    path = Path(data) / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"renderbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def seeded_inputs(spec: dict, seed: int) -> "tuple[list[str], dict]":
    """(the app's argv, the inputs both the program and the reference get)
    from the seed: the camera's starting orbit phase and any seeded flags
    the traffic names."""
    rng = np.random.default_rng(abs(int(seed)))
    config, traffic = spec["config"], spec["traffic"]
    inputs = {
        "orbit_start": float(rng.uniform(0.0, 2.0 * math.pi)),
        "dt": DT,
        "width": int(config["width"]),
        "height": int(config["height"]),
    }
    argv = list(config.get("app_args", [])) + list(traffic.get("app_args", []))
    for flag in traffic.get("seeded_flags", []):
        argv += [flag, str(int(rng.integers(0, 2 ** 31 - 1)))]
    return argv, inputs


def percentile(values, q: float) -> float:
    """The q-th percentile, linear between closest ranks."""
    return float(np.percentile(np.asarray(values, np.float64), q))


def forbidden_modules() -> "list[str]":
    """Loaded modules whose whole top-level name is JAX's or the JAX
    package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Program:
    """The port driven as its engine loop drives it: the app, a window of
    the configured size, an engine on ``device``, frames with a fixed dt.
    Presented frames are timed as they reach the window; the images of the
    judged frames (``judged``) and of the latest few are kept."""

    def __init__(self, spec: dict, argv: "list[str]", inputs: dict, device: str):
        os.environ["ZENITH_ORBIT_START"] = repr(inputs["orbit_start"])
        module, cls = spec["config"]["app"].split(":")
        from zenith_tpu_torch import asset
        from zenith_tpu_torch.core import log, profile
        from zenith_tpu_torch.core.cli import EngineArgs
        from zenith_tpu_torch.engine import Engine
        from zenith_tpu_torch.window import Window

        app_cls = getattr(importlib.import_module(module), cls)
        args = EngineArgs.parse_args(["-l", "warn"] + argv)
        profile.initialize()
        log.initialize(args.log_level.to_logging_level())
        asset.initialize()
        self.app = app_cls(args)
        self.window = Window(width=inputs["width"], height=inputs["height"])
        self.window.on_present = self._presented
        self.engine = Engine(self.window, device=device)
        self.app.prepare(self.engine.render_device, self.window)
        self.frames = 0  # frames rendered, warm-up included
        self.present_times: "dict[int, float]" = {}
        self.judged: "set[int]" = set()
        self.kept: "dict[int, np.ndarray]" = {}
        self.overflow = []  # the frames' device counters, read afterwards
        # The app state the scene carries from frame to frame (the traffic's
        # "state": name -> attribute path on the app), as left after each
        # kept frame: device values, read after the frames.
        self.state_paths = dict(spec["traffic"].get("state", {}))
        self.state: "dict[int, dict]" = {}

    def _presented(self, image, frame_index: int) -> None:
        self.present_times[frame_index] = time.perf_counter()
        self.kept[frame_index] = image

    def frame(self) -> None:
        self.engine.tick(DT)
        self.app.tick(DT)
        self.engine.render(self.app)
        retired = self.engine.last_retired
        self.overflow.append(retired.bin_overflow if retired is not None else 0)
        if self.state_paths:
            self.state[self.frames] = {n: self._attr(p) for n, p in self.state_paths.items()}
        self.frames += 1
        keep = self.judged | {k - 1 for k in self.judged}
        for k in [k for k in self.kept if k not in keep and k < self.frames - 8]:
            del self.kept[k]
        for k in [k for k in self.state if k not in keep and k < self.frames - 8]:
            del self.state[k]

    def _attr(self, path: str):
        obj = self.app
        for part in path.split("."):
            obj = getattr(obj, part)
        return obj

    def state_after(self, k: int) -> "dict | None":
        """The carried state as frame ``k`` left it, as floats."""
        if k not in self.state:
            return None
        return {n: (None if v is None else float(np.asarray(
            v.detach().cpu() if hasattr(v, "detach") else v).reshape(-1)[0]))
            for n, v in self.state[k].items()}

    def drain(self) -> None:
        import torch

        self.engine.swapchain.flush()
        if self.engine.render_device.device.type == "cuda":
            torch.cuda.synchronize()

    def overflowed(self, first: int, last: int) -> "dict[int, int]":
        """{frame: dropped entries} of the frames in [first, last) whose
        bins overflowed (read after the frames, when nothing waits on
        them)."""
        counts = {k: int(self.overflow[k]) for k in range(first, last)}
        return {k: v for k, v in counts.items() if v > 0}

    @property
    def frame_programs(self) -> int:
        return self.engine.frame_program_count


class Sample:
    """The judged frames: a uniform sample (reservoir) of ``k`` of the
    frames offered, drawn from the seed, decided as each frame is
    submitted, plus the last frame."""

    def __init__(self, prog: Program, k: int, seed: int):
        self.prog = prog
        self.k = k
        self.rng = np.random.default_rng(abs(int(seed)) + 1)
        self.items: "list[int]" = []
        self.n = 0

    def frame(self) -> None:
        """Render the next frame, offered to the sample."""
        item = self.prog.frames
        self.n += 1
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.n))
            if j < self.k:
                self.items[j] = item
        self.prog.judged = set(self.items) | (self.prog.judged & {0})
        self.prog.frame()

    def chosen(self) -> "list[int]":
        return sorted(set(self.items) | {self.prog.frames - 1})


def run_window(prog: Program, seconds: float, sample: Sample) -> dict:
    """Frames for ``seconds`` of host clock, from the first frame after the
    warm-up to the last present; returns the end-to-end readings."""
    first = prog.frames
    t0 = time.perf_counter()
    while True:
        sample.frame()
        if time.perf_counter() - t0 >= seconds:
            break
    last = prog.frames
    prog.drain()
    times = sorted(prog.present_times[k] for k in range(first, last) if k in prog.present_times)
    gaps = np.diff(np.asarray([t0] + times)) * 1e3
    return {
        "first": first,
        "last": last,
        "fps": len(times) / (times[-1] - t0) if times else 0.0,
        "frame_ms_p95": percentile(gaps, 95) if len(gaps) else 0.0,
    }


@contextmanager
def recording(trace: dict):
    """Record the K1 and K2 calls of the frames inside: each K1 call's
    bound on its bins and the pixels it covered, each K2 call's bound on
    its G-buffer and light table. Adds host reads: only outside timing."""
    import torch

    import roofline
    from zenith_tpu_torch.ops import draw as draw_mod
    from zenith_tpu_torch.renderer import deferred as deferred_mod

    real_k1 = draw_mod.raster_segmented
    real_k2 = deferred_mod.accumulate_point_lights

    def k1(bins, grid, init_z, *args, **kw):
        out = real_k1(bins, grid, init_z, *args, **kw)
        covered = int((out[1][-1] > 0).sum())
        ms, _, _ = roofline.k1_bound(bins, grid, covered)
        trace["k1_calls"].append({"bound_ms": ms})
        return out

    def k2(am, nr, pe, depth, cam, pos, col, rad, *args, **kw):
        out = real_k2(am, nr, pe, depth, cam, pos, col, rad, *args, **kw)
        p = torch.as_tensor(pos, dtype=torch.float32, device=depth.device).reshape(-1, 3)
        r = torch.as_tensor(rad, dtype=torch.float32, device=depth.device).reshape(-1, 1)
        lit = roofline.k2_lit_pairs(depth, pe, torch.cat([p, r], 1))
        h, w = depth.shape
        ms, _ = roofline.k2_bound(h, w, p.shape[0], lit)
        trace["k2_calls"].append({"bound_ms": ms})
        return out

    with mock.patch.object(draw_mod, "raster_segmented", k1), \
            mock.patch.object(deferred_mod, "accumulate_point_lights", k2):
        yield


def run_traced(prog: Program, traffic: dict, sample: Sample) -> dict:
    """The traced frames: a kernels-only profile (device spans, the busy
    share, kernel time by name), a profile with host operators (each
    render-graph node's device time, the launches), one recorded frame (the
    K1 and K2 bounds). Returns the trace that the per-layer readers take."""
    import torch

    from zenith_tpu_torch.core import profile

    n = int(traffic["trace_frames"])
    trace = {"k1_calls": [], "k2_calls": [], "frames": n}
    with profile.session(cpu=False):  # the profiler's own start-up
        prog.frame()
        prog.drain()
    programs0 = prog.frame_programs
    first = prog.frames
    t0 = time.perf_counter()
    with profile.session(cpu=False) as prof:
        for _ in range(n):
            sample.frame()
        torch.cuda.synchronize()
    trace["window_s"] = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    trace["kernels"] = [(e.name, e.time_range.start, e.time_range.end)
                        for e in prof.events() if e.device_type == cuda]
    with profile.session(cpu=True) as prof:
        for _ in range(n):
            sample.frame()
        torch.cuda.synchronize()
    scopes, launches, host, kernels2 = {}, 0, [], []
    for e in prof.events():
        if e.device_type == cuda:
            kernels2.append((e.time_range.start, e.time_range.end))
            continue
        scopes[e.name] = scopes.get(e.name, 0.0) + float(e.device_time_total)
        launches += e.name.startswith(("cudaLaunchKernel", "cuLaunchKernel"))
        if "::" not in e.name and not e.name.startswith(("cu", "Memcpy", "Memset")):
            host.append((e.time_range.start, e.time_range.end, e.name))
    trace["scope_device_us"] = scopes
    trace["launches"] = launches
    trace["host_gaps"] = host_gaps(kernels2, host)
    with recording(trace):
        sample.frame()
        prog.drain()
    trace["frame_programs_built"] = prog.frame_programs - programs0
    trace["first"], trace["last"] = first, prog.frames
    return trace


def device_record(peak_bytes: int, count: int, trace=None) -> dict:
    import torch

    import roofline

    rec = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
           "memory_peak_bytes": int(peak_bytes)}
    if trace is not None:
        spans = [(a, b) for _, a, b in trace["kernels"]]
        rec["busy_s"] = roofline.union_us(spans) / 1e6
        rec["window_s"] = trace["window_s"]
    return rec


def host_gaps(kernels, host) -> "list[list]":
    """The ten longest idle gaps between device spans, each named by the
    innermost host span (a render-graph node, an annotated function) open
    when the gap began: what the host was doing while the device waited."""
    gaps, end = [], None
    for a, b in sorted(kernels):
        if end is not None and a > end:
            gaps.append((end, a))
        end = b if end is None else max(end, b)
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    out = []
    for g0, g1 in gaps:
        open_spans = [(e - s, n) for s, e, n in host if s <= g0 < e]
        name = min(open_spans)[1] if open_spans else "outside any annotated host span"
        out.append([name[:120], (g1 - g0) / 1e6])
    return out


def breakdown(trace: dict) -> dict:
    """The ten device operations that took most time in the kernels-only
    profile, and the ten longest idle gaps of the profile with host
    operators, by what the host was doing."""
    by_name = {}
    for name, a, b in trace["kernels"]:
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n[:120], s] for n, s in ops], "idle_gaps": trace["host_gaps"]}


def compare(got: np.ndarray, ref: np.ndarray) -> dict:
    """The numbers a judged frame is held to: the share (%) of its 8-bit
    values more than 1 off the reference's, and the mean difference in
    8-bit steps."""
    d = np.abs(got.astype(np.int16) - ref.astype(np.int16))
    return {"off_pct": float((d > 1).mean() * 100.0), "mean_lsb": float(d.mean())}


def judge(spec: dict, argv: "list[str]", inputs: dict, frames: "dict[int, np.ndarray]",
          want: "list[int]", device: str, precision: str = "reference",
          states: "dict | None" = None) -> "tuple[dict, list]":
    """Compare each judged frame with the reference (``compare``); where
    the scene carries an exposure from frame to frame, the reference adapts
    from the program's exposure of the frame before, and the program's
    exposure of the judged frame is held to the reference's too
    (``exposure_rel``, relative). Returns ({name: (worst value, limit)},
    per-frame lines)."""
    import torch

    from reference import render_frame

    limits = spec["checks"]["limits"]
    states = states or {}
    worst = {name: 0.0 for name in limits}
    lines = []
    scene = None
    for k in want:
        got = frames.get(k)
        after = states.get(k) or {}
        before = states.get(k - 1) or {}
        if got is None or ("exposure" in limits and after.get("exposure") is None):
            # A judged frame that never reached the window fails every number.
            for name in worst:
                worst[name] = max(worst[name], MISSING[name])
            lines.append(f"frame {k}: never presented")
            continue
        t0 = time.perf_counter()
        ref, scene, ev = render_frame(spec["config"]["reference"], argv, inputs, k, device,
                                      precision=precision, scene=scene,
                                      exposure_prev=before.get("exposure"))
        ref = ref.cpu().numpy()
        ref_s = time.perf_counter() - t0
        vals = compare(got, ref)
        if "exposure_rel" in limits:
            vals["exposure_rel"] = abs(after["exposure"] - ev) / ev
        for name in worst:
            worst[name] = max(worst[name], vals[name])
        lines.append(f"frame {k}: " + ", ".join(f"{n} {v!r}" for n, v in vals.items())
                     + f" (reference {ref_s:.2f} s)")
        del ref
        if device != "cpu":
            torch.cuda.empty_cache()
    return {n: (worst[n], float(limits[n])) for n in worst}, lines


def parse_args(argv):
    p = argparse.ArgumentParser("renderbench")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=[0, 1], default=0)
    return p.parse_args(argv)


def run(args, age_at_start: float, t_start: float, root: Path, device: str = "cuda",
        chip_check: bool = True, break_program=None, data: Path = HERE) -> dict:
    """One run; returns the result object. ``chip_check=False`` and
    ``break_program`` (a context manager around the program's frames) are
    for the harness's own tests."""
    bench = find_benchmark(root)
    spec = cell_spec(bench, args.workload, root, data)
    chips = int(spec["cell"]["chips"])
    import torch

    if chip_check:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            raise Fail(f"{args.workload} needs {chips} CUDA device(s); "
                       f"torch.cuda.is_available() = {torch.cuda.is_available()}, "
                       f"device_count() = {torch.cuda.device_count()}")
    argv, inputs = seeded_inputs(spec, args.seed)
    traffic = spec["traffic"]
    with (break_program() if break_program is not None else nullcontext()):
        prog = Program(spec, argv, inputs, device)
        if traffic.get("judge_first"):
            prog.judged = {0}
        for _ in range(int(traffic["warmup_frames"])):
            prog.frame()
        prog.drain()
        if device != "cpu":
            torch.cuda.reset_peak_memory_stats()
        setup_s = age_at_start + (time.perf_counter() - t_start)
        sample = Sample(prog, int(traffic["judged_frames"]) - 1, args.seed)
        trace = readings = None
        if args.trace:
            trace = run_traced(prog, traffic, sample)
            first, last = trace["first"], trace["last"]
        else:
            readings = run_window(prog, args.seconds, sample)
            first, last = readings["first"], readings["last"]
        want = sample.chosen() + ([0] if traffic.get("judge_first") else [])
        states = {k: prog.state_after(k) for k in set(want) | {k - 1 for k in want}}
        unpresented = [k for k in range(first, last) if k not in prog.present_times]
        overflowed = prog.overflowed(first, last)
        failed = len(set(unpresented) | set(overflowed))
        peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
        frames = {k: prog.kept[k] for k in want if k in prog.kept}
        prog.engine.shutdown()
        del prog, sample
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()

    metrics = {}
    if trace is None:
        units = {m["name"]: m["unit"] for m in spec["end_to_end"]}
        values = {"fps": readings["fps"], "frame_ms_p95": readings["frame_ms_p95"],
                  "setup_s": setup_s}
        for name, unit in units.items():
            metrics[name] = {"value": values[name], "unit": unit}
    else:
        for m in spec["per_layer"]:
            value = load_metric(m["name"], data)(trace)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    checks, lines = judge(spec, argv, inputs, frames, sorted(want), device, states=states)
    if unpresented:
        lines.insert(0, f"frames never presented: {unpresented}")
    if overflowed:
        lines.insert(0, f"frames whose bins overflowed (entries dropped): {overflowed}")
    correct = all(v <= lim for v, lim in checks.values())
    result = {
        "correct": bool(correct),
        "attempted": int(last - first),
        "failed": int(failed),
        "metrics": metrics,
        "device": (device_record(peak, chips, trace) if device != "cpu"
                   else {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}),
    }
    if trace is not None:
        result["breakdown"] = breakdown(trace)
    result["checks"] = {n: {"value": v, "limit": lim} for n, (v, lim) in checks.items()}
    result["_lines"] = lines
    return result


def main(argv, age_at_start: float, t_start: float) -> int:
    args = parse_args(argv)
    root = Path.cwd()
    try:
        result = run(args, age_at_start, t_start, root)
    except Fail as e:
        print(f"renderbench: {e}", file=sys.stderr)
        return 2
    found = forbidden_modules()
    if found:
        print(f"renderbench: the run loaded {', '.join(found)}; no result", file=sys.stderr)
        return 3
    lines = result.pop("_lines")
    for line in lines:
        print(line, file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
