"""Engine CLI flags (reference zenith-core/src/cli.rs:6-47).

`EngineArgs.parse_args()` mirrors the reference clap parser: a
``-l/--log-level`` enum flag plus trailing var-args forwarded to the app.
"""

from __future__ import annotations

import argparse
import enum
from dataclasses import dataclass, field


class LogLevel(enum.Enum):
    """Log level filter (reference cli.rs:6-28)."""

    OFF = "off"
    ERROR = "error"
    WARN = "warn"
    INFO = "info"
    DEBUG = "debug"
    TRACE = "trace"

    def to_logging_level(self) -> str:
        return {
            LogLevel.OFF: "CRITICAL",
            LogLevel.ERROR: "ERROR",
            LogLevel.WARN: "WARNING",
            LogLevel.INFO: "INFO",
            LogLevel.DEBUG: "DEBUG",
            LogLevel.TRACE: "DEBUG",
        }[self]


@dataclass
class EngineArgs:
    """Parsed engine arguments (reference cli.rs:30-47)."""

    log_level: LogLevel = LogLevel.INFO
    app_args: list[str] = field(default_factory=list)
    # Swapchain pacing-fence interval (frames between amortized hard
    # fences; swapchain.py). None = ZENITH_PACE_STRIDE env or default 128.
    pace_stride: "int | None" = None

    @staticmethod
    def parse_args(argv: list[str] | None = None) -> "EngineArgs":
        parser = argparse.ArgumentParser(prog="zenith", add_help=True)
        parser.add_argument(
            "-l",
            "--log-level",
            type=str,
            choices=[lv.value for lv in LogLevel],
            default=LogLevel.INFO.value,
            help="log level filter",
        )
        parser.add_argument(
            "--pace-stride",
            type=int,
            default=None,
            help="swapchain pacing-fence interval in frames (default 128; "
                 "lower bounds worst-case latency, higher maximizes "
                 "async throughput)",
        )
        parser.add_argument(
            "app_args", nargs=argparse.REMAINDER, help="arguments passed to the app"
        )
        # Arguments the engine does not know go to the app, as those after
        # "--" do: launch(SceneApp, argv=["--mode", "forward"]) works.
        ns, unknown = parser.parse_known_args(argv)
        app_args = list(ns.app_args)
        if app_args and app_args[0] == "--":
            app_args = app_args[1:]
        app_args = unknown + app_args
        args = EngineArgs(
            log_level=LogLevel(ns.log_level), app_args=app_args,
            pace_stride=ns.pace_stride,
        )
        if ns.pace_stride is not None:
            # Swapchains read the env at construction; the flag is the
            # user-facing way to set it (EngineArgs → env → Swapchain).
            import os

            os.environ["ZENITH_PACE_STRIDE"] = str(ns.pace_stride)
        return args
