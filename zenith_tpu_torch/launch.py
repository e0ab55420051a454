"""Engine entry point (reference zenith/src/lib.rs:31-44; torch port of
zenith_tpu/launch.py)."""

from __future__ import annotations

from typing import Optional, Type

import torch

from zenith_tpu_torch.app import RenderableApp
from zenith_tpu_torch.core import log, profile
from zenith_tpu_torch.core.cli import EngineArgs
from zenith_tpu_torch.main_loop import EngineLoop
from zenith_tpu_torch.window import Window


def launch(
    app_class: "Type[RenderableApp]",
    argv: "Optional[list[str]]" = None,
    window: "Optional[Window]" = None,
    max_frames: "Optional[int]" = None,
    serve: "Optional[int]" = None,
    fps_cap: float = 60.0,
    device: "torch.device | str" = "cuda",
) -> EngineLoop:
    """Parse args → init logging/profiling/assets → construct app → run the
    loop on ``device`` (lib.rs:31-44). Returns the loop for inspection
    (tests/benches). CUDA is the default and raises where there is none;
    tests pass ``device="cpu"``.

    ``serve=PORT`` runs the loop interactively behind the HTTP viewer
    (``viewer.serve_loop``; port 0 picks a free port) instead of running it
    headless."""
    args = EngineArgs.parse_args(argv)
    profile.initialize()
    log.initialize(args.log_level.to_logging_level())
    # Debug log level turns validation on (the reference's validation layers
    # are a debug-build default, zenith-rhi/Cargo.toml:23); an explicit
    # ZENITH_VALIDATE env setting still wins inside core.validate.enabled().
    import os

    from zenith_tpu_torch.core import validate
    from zenith_tpu_torch.core.cli import LogLevel

    if (
        args.log_level in (LogLevel.DEBUG, LogLevel.TRACE)
        and "ZENITH_VALIDATE" not in os.environ
    ):
        validate.force(True)

    from zenith_tpu_torch import asset

    asset.initialize()

    app = app_class(args)
    loop = EngineLoop(app, window=window, device=device)
    if serve is None:
        loop.run(max_frames=max_frames)
        return loop
    from zenith_tpu_torch.viewer import serve_loop

    serve_loop(loop, port=serve, fps_cap=fps_cap, max_frames=max_frames)
    return loop
