"""The render benchmark: one run of one cell of BENCHMARK.json.

    python3 renderbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the cell's CUDA devices.
Prints the result as the last line of standard output, and each number of
the correctness check beside its limit as the last lines of standard
error. Exits non-zero with no result where the devices are missing, the
program cannot be loaded, or the run loaded JAX or the JAX package.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))


def process_age() -> float:
    """Seconds since this process started (Linux), else 0."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


AGE_AT_START = process_age()

# Kernel caches stay in fixed directories of the checkout, so that only a
# checkout's first run builds (the program's own library is built under
# zenith_tpu_torch/_build/, inside the checkout too).
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = os.path.join(HERE, ".cache", sub)
sys.path.insert(0, HERE)
sys.path.insert(1, os.path.dirname(HERE))

if __name__ == "__main__":
    from harness import main

    sys.exit(main(sys.argv[1:], AGE_AT_START, T_START))
