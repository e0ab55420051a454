"""Validation-mode switch — the analog of the reference's Vulkan validation
layers (zenith-rhi/Cargo.toml default=["validation"]; core.rs:15-16,180-198).

The reference ships validation ON by default in debug builds; here the
equivalent "where bugs are made" defaults are: pytest runs (tests/conftest.py
sets ZENITH_VALIDATE=1) and the sandbox's --debug log level (cli.py). Release
frame loops leave it off — the checks add device reductions (NaN screening)
and per-draw Python.
"""

from __future__ import annotations

import os

_FORCE: "bool | None" = None


def enabled() -> bool:
    """True when graph/draw validation checks should run."""
    if _FORCE is not None:
        return _FORCE
    return os.environ.get("ZENITH_VALIDATE", "0") not in ("", "0", "false")


def force(value: "bool | None") -> None:
    """Override the env switch programmatically (None = back to env).
    The engine turns this on when launched at debug log level."""
    global _FORCE
    _FORCE = value
