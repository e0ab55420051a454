"""Foundation layer — mirrors zenith-core (reference zenith-core/src/lib.rs:1-8).

Pure Python/NumPy: logging, CLI flags, angle/matrix math, camera, input.
Nothing in this package touches torch; camera/input math is host-side
scalar work that feeds small arrays into the frame function each frame.
"""

from zenith_tpu_torch.core import camera, cli, fileio, input, log, mathtypes, profile
from zenith_tpu_torch.core.camera import (
    NEAR_PLANE,
    WORLD_SPACE_FORWARD,
    WORLD_SPACE_RIGHT,
    WORLD_SPACE_UP,
    Camera,
    CameraController,
)
from zenith_tpu_torch.core.cli import EngineArgs, LogLevel
from zenith_tpu_torch.core.input import (
    AxisMapping,
    InputActionMapper,
    InputManager,
    KeyState,
)
from zenith_tpu_torch.core.mathtypes import Degree, Radians

__all__ = [
    "AxisMapping",
    "Camera",
    "CameraController",
    "Degree",
    "EngineArgs",
    "InputActionMapper",
    "InputManager",
    "KeyState",
    "LogLevel",
    "NEAR_PLANE",
    "Radians",
    "WORLD_SPACE_FORWARD",
    "WORLD_SPACE_RIGHT",
    "WORLD_SPACE_UP",
    "camera",
    "cli",
    "fileio",
    "input",
    "log",
    "mathtypes",
    "profile",
]
