"""The correctness check's control, on the card at a cell's own size: the
reference computed with TF32 matrix products (the precision below the
float32 that the scenes state) in the program's place, judged against the
full-precision reference by the same numbers as a run.

    python3 renderbench/control.py --workload <cell> --seeds <n> [<n> ...]

prints one JSON line a seed: the worst of each number over the judged
frames (the frames a run of that seed would judge: after the warm-up,
spread over a nominal window). The benchmark's runs do not run it.
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)


def control_readings(spec: dict, seed: int, device, frames: "list[int]") -> dict:
    """{number: worst over ``frames``} of the TF32 reference against the
    reference, for ``seed``; a scene with eye adaptation starts both from
    the first frame's exposure."""
    import harness
    from reference import render_frame

    argv, inputs = harness.seeded_inputs(spec, seed)
    worst = {}
    scene = None
    for k in frames:
        ref, scene, ev = render_frame(spec["config"]["reference"], argv, inputs, k, device,
                                      scene=scene)
        ctl, _, ev_ctl = render_frame(spec["config"]["reference"], argv, inputs, k, device,
                                      precision="tf32", scene=scene)
        vals = harness.compare(ctl.cpu().numpy(), ref.cpu().numpy())
        if ev is not None:
            vals["exposure_rel"] = abs(ev_ctl - ev) / ev
        for n, v in vals.items():
            worst[n] = max(worst.get(n, 0.0), v)
    return worst


def nominal_frames(spec: dict, count: int = 3, window: int = 240) -> "list[int]":
    warm = int(spec["traffic"].get("warmup_frames", 8))
    return [warm + (window - 1) * i // max(count - 1, 1) for i in range(count)]


def main(argv=None) -> int:
    import torch

    import harness

    p = argparse.ArgumentParser("renderbench-control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 2
    root = Path.cwd()
    spec = harness.cell_spec(harness.find_benchmark(root), args.workload, root)
    frames = nominal_frames(spec)
    for seed in args.seeds:
        t0 = time.perf_counter()
        worst = control_readings(spec, seed, "cuda", frames)
        print(json.dumps({"workload": args.workload, "seed": seed, "frames": frames,
                          "control": worst, "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(1, os.path.dirname(HERE))
    sys.exit(main())
