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

``load_blend_kernel`` builds ``csrc/raster_blend.cu`` (kernels K5 and K6)
once per fragment shader: a kernel-safe shader carries the text of a CUDA
``__device__`` function (``Shader.device_source``), and the build writes a
translation unit of the attribute layout's column macros, that text and the
kernel source, compiles it with ``-fmad=false`` into a library named by the
hash of all three, and loads it. ``shader_builds`` counts the compilations
(not the reuses), so a caller can show that none fell inside a timed window.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# Compiled per fragment shader (load_blend_kernel), not into the library.
BLEND_SOURCE = CSRC / "raster_blend.cu"

_lib: "Optional[ctypes.CDLL]" = None
_blend_libs: "dict[tuple, ctypes.CDLL]" = {}  # by (device source, layout)
shader_builds = 0  # nvcc runs made by load_blend_kernel in this process
# Guards the process-wide state that the shards of an SPMD frame (threads,
# parallel.spmd) share: the launch counters, the build counter and the table
# of build locks. It is held for updates only, never across a build.
STATE_LOCK = threading.RLock()
# One lock per lazily built library (the kernel library, each shader's blend
# kernel): threads that ask for the same one build it once, different ones
# build in parallel.
_build_locks: "dict[object, threading.Lock]" = {}


def _build_lock(key) -> threading.Lock:
    with STATE_LOCK:
        return _build_locks.setdefault(key, threading.Lock())


def count_launch(wrapper, attr: str = "launches") -> None:
    """Add one to a kernel wrapper's launch counter (``wrapper.<attr>``)."""
    with STATE_LOCK:
        setattr(wrapper, attr, getattr(wrapper, attr) + 1)


def on_cuda(t: torch.Tensor) -> bool:
    """Whether ``t`` lives on a CUDA device (the kernel route)."""
    return t.device.type == "cuda"


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _sources() -> "list[Path]":
    return sorted(p for p in CSRC.iterdir()
                  if p.suffix in (".cu", ".cuh", ".h") and p != BLEND_SOURCE)


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
    if _lib is not None:
        return _lib
    with _build_lock("kernels"):
        return _load_kernels()


def _load_kernels() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build_kernels()))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.zn_raster_segmented.restype = ctypes.c_int
    lib.zn_raster_segmented.argtypes = [
        p, p, p, p,  # blk_tile_y, blk_tile_x, blk_count, blk_init
        p, p,  # rows, rects
        p, p,  # z, acc (updated in place)
        i, i, i, i, i,  # num_blocks, chunk, row_stride, a_n, wp
        i, i, i,  # hp, tile_h, tile_w
        i, i, i,  # compare, depth_write, depth_clamp
        f, f,  # sample offset
        p,  # stream
    ]
    lib.zn_raster_segmented_stencil.restype = ctypes.c_int
    lib.zn_raster_segmented_stencil.argtypes = [
        p, p, p, p, p, p,  # routing tables, rows, rects
        p, p, p,  # z, acc, stencil (updated in place)
        i, i, i, i, i, i, i, i,  # num_blocks, chunk, row_stride, a_n, wp, hp, tile_h, tile_w
        i, i, i,  # compare, depth_write, depth_clamp
        f, f,  # sample offset
        p,  # faces: 14 host ints
        p,  # stream
    ]
    lib.zn_raster_segmented_peel.restype = ctypes.c_int
    lib.zn_raster_segmented_peel.argtypes = [
        p, p, p, p, p, p,  # routing tables, rows, rects
        p, p,  # z, acc (updated in place)
        p,  # z_bound
        i, i, i, i, i, i, i, i,  # num_blocks, chunk, row_stride, a_n, wp, hp, tile_h, tile_w
        i, i, i,  # compare, depth_write, depth_clamp
        f, f,  # sample offset
        i,  # bound_compare
        p,  # stream
    ]
    lib.zn_visibility.restype = ctypes.c_int
    lib.zn_visibility.argtypes = [
        p, p, p, p,  # counts (T,), rast (T, K, 16), rects (T, K, 4), slots (T, K)
        p, p,  # z, slot (updated in place)
        i, i, i, i, i, i,  # num_tiles, k, tiles_x, wp, tile_h, tile_w
        i, i,  # compare, depth_write
        p,  # stream
    ]
    lib.zn_raster_interp.restype = ctypes.c_int
    lib.zn_raster_interp.argtypes = [
        p, p, p, p,  # counts (T,), rast (T, K, 16), rects (T, K, 4), attr (T, K, 3 a_n)
        p, p,  # z (updated in place), acc (written where a record won)
        i, i, i, i, i, i, i, i,  # num_tiles, k, a_n, tiles_x, wp, hp, tile_h, tile_w
        i, i,  # compare, depth_write
        p,  # stream
    ]
    lib.zn_tiled_lights.restype = ctypes.c_int
    lib.zn_tiled_lights.argtypes = [
        p, p, p, p,  # albedo_metal, normal_rough, pos_emissive (H, W, 4), depth (H, W)
        p, p,  # lights (L, 16), camera (3,)
        p,  # out (H, W, 3)
        i, i, i,  # num_lights, h, w
        p,  # stream
    ]
    _lib = lib
    return lib


def _c_name(name: str) -> str:
    return "".join(ch if ch.isalnum() else "_" for ch in name)


def blend_unit_source(device_source: str, attr_layout: "Sequence[tuple[str, int]]") -> str:
    """The translation unit of K5/K6 for one shader: the layout's column
    macros (``ZN_V_<varying>``, ``ZN_U_<uniform>``, ``ZN_FRONT_COL``,
    ``ZN_DRAW_ID_COL``, ``ZN_A_N``), the shader's device function, then the
    kernel source. ``attr_layout`` is the (name, channels) list whose columns
    ride the records, the trailing 1/w column not included."""
    lines = ["// Generated by zenith_tpu_torch.ops.runtime.blend_unit_source."]
    off = 0
    front = draw_id = -1
    for name, ch in attr_layout:
        if name == "__front":
            front = off
        elif name == "__draw_id":
            draw_id = off
        elif name.startswith("__u_"):
            lines.append(f"#define ZN_U_{_c_name(name[4:])} {off}")
        else:
            lines.append(f"#define ZN_V_{_c_name(name)} {off}")
        off += ch
    lines += [
        f"#define ZN_A_N {off + 1}",
        f"#define ZN_FRONT_COL {front}",
        f"#define ZN_DRAW_ID_COL {draw_id}",
        "#include <cuda_runtime.h>",
        "#include <math.h>",
        device_source,
        f'#include "{BLEND_SOURCE.name}"',
        "",
    ]
    return "\n".join(lines)


def load_blend_kernel(device_source: str,
                      attr_layout: "Sequence[tuple[str, int]]") -> ctypes.CDLL:
    """K5/K6 compiled for one (shader device source, attribute layout),
    built on first use and cached on disk by a hash of the generated unit and
    the kernel sources, and in this process by (source, layout)."""
    shader_key = (device_source, tuple(attr_layout))
    lib = _blend_libs.get(shader_key)
    if lib is not None:  # loaded before in this process
        return lib
    with _build_lock(shader_key):
        return _load_blend_kernel(device_source, attr_layout)


def _load_blend_kernel(device_source: str,
                       attr_layout: "Sequence[tuple[str, int]]") -> ctypes.CDLL:
    global shader_builds
    shader_key = (device_source, tuple(attr_layout))
    lib = _blend_libs.get(shader_key)
    if lib is not None:
        return lib
    unit = blend_unit_source(device_source, attr_layout)
    h = hashlib.sha256(unit.encode())
    for src in (BLEND_SOURCE, CSRC / "raster_common.cuh"):
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    key = h.hexdigest()[:16]
    so = BUILD_DIR / f"libzenith_blend_{key}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        cu = BUILD_DIR / f"blend_{key}.cu"
        cu.write_text(unit)
        tmp = BUILD_DIR / f"{so.stem}.{os.getpid()}.so.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-fmad=false", "-I", str(CSRC), "-shared",
               str(cu), "-o", str(tmp)]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) on the blend kernel of a fragment shader:\n"
                f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}"
            )
        so.with_suffix(".log").write_text(f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)
        with STATE_LOCK:
            shader_builds += 1
    lib = ctypes.CDLL(str(so))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    common = [p, p, p, p, p, p]  # routing tables, rows, rects
    tail = [i, i, i, i, i, i, i, i, i, f, f]  # num_blocks .. depth_clamp, sample offset
    lib.zn_raster_blend.restype = ctypes.c_int
    lib.zn_raster_blend.argtypes = [*common, p, p, *tail, p, p]  # z, color; blend, stream
    lib.zn_raster_blend_stencil.restype = ctypes.c_int
    lib.zn_raster_blend_stencil.argtypes = [*common, p, p, p, *tail, p, p, p]
    lib.log_path = so.with_suffix(".log")
    _blend_libs[shader_key] = lib
    return lib
