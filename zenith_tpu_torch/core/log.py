"""Logging initialization (reference zenith-core/src/log.rs:3-13).

The reference wires env_logger with a CLI-selected level filter plus
module-level filters; we mirror that with the stdlib logging module and the
``ZENITH_LOG`` environment variable (analog of RUST_LOG) for per-module
overrides, e.g. ``ZENITH_LOG=zenith_tpu_torch.rendergraph=DEBUG,zenith_tpu_torch.ops=WARNING``.
"""

from __future__ import annotations

import logging
import os

_FORMAT = "[%(asctime)s %(levelname)-5s %(name)s] %(message)s"
_DATE_FORMAT = "%H:%M:%S"

_initialized = False


def initialize(level: str = "INFO") -> None:
    """Initialize the root logger; safe to call more than once."""
    global _initialized
    if _initialized:
        logging.getLogger().setLevel(level.upper())
        return
    logging.basicConfig(
        level=level.upper(), format=_FORMAT, datefmt=_DATE_FORMAT, force=True
    )
    # Per-module overrides, RUST_LOG-style (reference log.rs:9 parse_default_env).
    spec = os.environ.get("ZENITH_LOG", "")
    for item in filter(None, (s.strip() for s in spec.split(","))):
        if "=" in item:
            module, _, mod_level = item.partition("=")
            logging.getLogger(module.strip()).setLevel(mod_level.strip().upper())
        else:
            logging.getLogger().setLevel(item.upper())
    _initialized = True


def get(name: str) -> logging.Logger:
    return logging.getLogger(name)
