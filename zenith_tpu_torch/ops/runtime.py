"""Device gating and the hand-written kernel build.

Counterpart of zenith_tpu/ops/runtime.py. There is no interpreter mode: a
wrapper runs its kernel's plain PyTorch version only for tensors that lie
on the CPU (``on_cuda`` is False); for CUDA tensors it launches the kernel
or raises.

``load_kernels`` builds every source under ``zenith_tpu_torch/csrc/`` into
one shared library with a plain C interface, on first use, with ``nvcc`` for
``sm_90a`` (one ``nvcc`` per source, all started together, then one link),
and loads it with ``ctypes``. The library lands in
``zenith_tpu_torch/_build/`` under a name derived from a hash of the
sources, so an edited source rebuilds and an unchanged one is reused; the
compiler's register and spill report (``-Xptxas -v``) lands beside it as
``<library>.log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lib: "Optional[ctypes.CDLL]" = None


def on_cuda(t: torch.Tensor) -> bool:
    """Whether ``t`` lives on a CUDA device (the kernel route)."""
    return t.device.type == "cuda"


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _sources() -> "list[Path]":
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh", ".h"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin): cannot build the CUDA kernels")


def library_path() -> Path:
    """Where the build for the current sources lives."""
    h = hashlib.sha256()
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libzenith_kernels_{h.hexdigest()[:16]}.so"


def build_kernels() -> Path:
    """Compile ``csrc/*.cu`` into the hashed library unless it exists: one
    ``nvcc -c`` per source, run in parallel, then one ``nvcc -shared``."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}"
    nvcc = _nvcc()
    jobs = []
    for src in (p for p in _sources() if p.suffix == ".cu"):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    log = []
    failed = None
    for cmd, _, proc in jobs:
        out, err = proc.communicate(timeout=900)
        log.append(f"$ {' '.join(cmd)}\n{out}{err}")
        if proc.returncode != 0 and failed is None:
            failed = f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}\n{err}"
    if failed is not None:
        raise RuntimeError(failed)
    tmp = BUILD_DIR / f"{tag}.so.tmp"
    cmd = [nvcc, "-shared", "-o", str(tmp), *[str(obj) for _, obj, _ in jobs]]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc link failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}"
        )
    for _, obj, _ in jobs:
        obj.unlink()
    so.with_suffix(".log").write_text("\n".join(log))
    os.replace(tmp, so)
    return so


def load_kernels() -> ctypes.CDLL:
    """The kernel library, built on first use and declared for ctypes."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build_kernels()))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.zn_raster_segmented.restype = ctypes.c_int
    lib.zn_raster_segmented.argtypes = [
        p, p, p, p,  # blk_tile_y, blk_tile_x, blk_count, blk_init
        p,  # rows
        p, p,  # z, acc (updated in place)
        i, i, i, i, i,  # num_blocks, chunk, row_stride, a_n, wp
        i, i, i,  # hp, tile_h, tile_w
        i, i, i,  # compare, depth_write, depth_clamp
        f, f,  # sample offset
        p,  # stream
    ]
    lib.zn_tiled_lights.restype = ctypes.c_int
    lib.zn_tiled_lights.argtypes = [
        p, p, p, p,  # albedo_metal, normal_rough, pos_emissive (H, W, 4), depth (H, W)
        p, p,  # lights (L, 16), camera (3,)
        p,  # out (H, W, 3)
        i, i, i, i, i,  # num_lights, h, w, tile_h, tile_w
        p,  # stream
    ]
    _lib = lib
    return lib
