"""Window/device event model — the framework's analog of the winit event
types the reference consumes in zenith-core (input.rs:2-3, camera.rs:13).

The reference runs under a winit OS event loop; this framework is headless
(frames are device arrays, "present" is a host readback), so events come from
whatever front-end drives the loop — a replay script, a test, or an
interactive viewer. The types below are the stable contract between that
front-end and InputManager / CameraController.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass


class ElementState(enum.Enum):
    PRESSED = "pressed"
    RELEASED = "released"


class MouseButton(enum.Enum):
    LEFT = "left"
    RIGHT = "right"
    MIDDLE = "middle"


class KeyCode(enum.Enum):
    """Physical key codes (subset of winit::keyboard::KeyCode)."""

    KEY_W = "w"
    KEY_A = "a"
    KEY_S = "s"
    KEY_D = "d"
    KEY_Q = "q"
    KEY_E = "e"
    KEY_R = "r"
    KEY_F = "f"
    SPACE = "space"
    SHIFT_LEFT = "shift_left"
    CONTROL_LEFT = "control_left"
    ALT_LEFT = "alt_left"
    SUPER_LEFT = "super_left"
    ESCAPE = "escape"
    TAB = "tab"
    ENTER = "enter"
    ARROW_UP = "arrow_up"
    ARROW_DOWN = "arrow_down"
    ARROW_LEFT = "arrow_left"
    ARROW_RIGHT = "arrow_right"


@dataclass(frozen=True)
class WindowEvent:
    """Base class for per-window events."""


@dataclass(frozen=True)
class KeyboardInput(WindowEvent):
    key: KeyCode
    state: ElementState
    repeat: bool = False


@dataclass(frozen=True)
class MouseInput(WindowEvent):
    button: MouseButton
    state: ElementState


@dataclass(frozen=True)
class ModifiersChanged(WindowEvent):
    shift: bool = False
    ctrl: bool = False
    alt: bool = False
    super_key: bool = False


@dataclass(frozen=True)
class Focused(WindowEvent):
    focused: bool


@dataclass(frozen=True)
class Resized(WindowEvent):
    width: int
    height: int


@dataclass(frozen=True)
class RedrawRequested(WindowEvent):
    pass


@dataclass(frozen=True)
class CloseRequested(WindowEvent):
    pass


@dataclass(frozen=True)
class DeviceEvent:
    """Base class for raw device events."""


@dataclass(frozen=True)
class MouseMotion(DeviceEvent):
    dx: float
    dy: float
