"""zenith_tpu_torch — the PyTorch/CUDA port of zenith_tpu.

The same layers and names as zenith_tpu, with tensors on an explicit
``torch.device`` in place of jax arrays, and every Pallas kernel on a ported
path replaced by a kernel written by hand for Hopper (``csrc/``), beside its
plain PyTorch version:

    sandbox apps                 — user code
    zenith_tpu_torch (facade)    — launch / App / Engine / EngineLoop
    zenith_tpu_torch.renderer    — feature renderers (triangle)
    zenith_tpu_torch.rendergraph — per-frame pass DAG → one cached frame function
    zenith_tpu_torch.rhi         — device, resources, shaders-as-functions, state
    zenith_tpu_torch.ops         — the rasterizer: torch ops + CUDA kernel K1
    zenith_tpu_torch.core        — foundation: log, cli, math, camera, input

The package imports torch, never jax or zenith_tpu; ROADMAP.md lists what
is still to be ported.
"""

import importlib
from typing import Any

__version__ = "0.1.0"

_FACADE = {
    "App": "zenith_tpu_torch.app",
    "Args": "zenith_tpu_torch.app",
    "RenderableApp": "zenith_tpu_torch.app",
    "RenderContext": "zenith_tpu_torch.app",
    "Engine": "zenith_tpu_torch.engine",
    "EngineLoop": "zenith_tpu_torch.main_loop",
    "launch": "zenith_tpu_torch.launch",
}
_SUBMODULES = (
    "core",
    "rhi",
    "ops",
    "rendergraph",
    "renderer",
    "app",
    "engine",
    "interop",
    "launch",
    "main_loop",
    "window",
)

__all__ = sorted(set(_FACADE) | set(_SUBMODULES))


def __getattr__(name: str) -> Any:
    if name in _FACADE:
        module = importlib.import_module(_FACADE[name])
        return getattr(module, name)
    if name in _SUBMODULES:
        return importlib.import_module(f"zenith_tpu_torch.{name}")
    raise AttributeError(f"module 'zenith_tpu_torch' has no attribute {name!r}")
