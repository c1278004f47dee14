"""Keyboard controls and help overlay for the VR viewer.

Reference: native_viewer/controls.py:14-329 — GLFW key bindings for playback,
projection cycling, screen distance/size, format cycling, eye swap, WASD
alignment and reset. The binding table and state transitions are pure logic
(testable); only the GLFW callback wiring needs a window.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

from .constants import FORMAT_CYCLE, PROJECTION_CYCLE, Projection, StereoFormat

CONTROLS_HELP = [
    ("Space", "Play/pause video"),
    ("R", "Restart video"),
    ("Left/Right", "Seek -/+ 5 seconds"),
    ("L", "Toggle loop"),
    ("P", "Cycle projection (flat/curved/360/180)"),
    ("PgUp/PgDn", "Screen distance +/-"),
    ("+/-", "Screen size +/-"),
    ("Shift+S", "Cycle stereo format (SBS/OU/mono)"),
    ("E", "Swap eyes"),
    ("W/A/S/D", "Align screen up/left/down/right"),
    ("0", "Reset view settings"),
    ("Q/Esc", "Quit viewer"),
]


@dataclasses.dataclass
class ViewerState:
    """Mutable view settings driven by the keyboard (reference defaults)."""

    projection: Projection = Projection.FLAT
    stereo_format: StereoFormat = StereoFormat.SBS
    swap_eyes: bool = False
    screen_distance: float = 3.0
    screen_size: float = 4.0
    align_x: float = 0.0
    align_y: float = 0.0
    paused: bool = False
    loop: bool = True
    seek_request: float = 0.0
    restart_request: bool = False
    quit_request: bool = False

    def reset_view(self):
        self.screen_distance = 3.0
        self.screen_size = 4.0
        self.align_x = 0.0
        self.align_y = 0.0


class KeyboardHandler:
    """Maps key names to state transitions; inject into a GLFW key callback."""

    def __init__(self, state: ViewerState):
        self.state = state
        self._actions: Dict[str, Callable[[], None]] = {
            "space": self._toggle_pause,
            "r": self._restart,
            "left": lambda: self._seek(-5.0),
            "right": lambda: self._seek(+5.0),
            "l": self._toggle_loop,
            "p": self._cycle_projection,
            "page_up": lambda: self._distance(+0.5),
            "page_down": lambda: self._distance(-0.5),
            "equal": lambda: self._size(+0.5),
            "minus": lambda: self._size(-0.5),
            "shift+s": self._cycle_format,
            "e": self._swap,
            "w": lambda: self._align(0.0, +0.1),
            "a": lambda: self._align(-0.1, 0.0),
            "s": lambda: self._align(0.0, -0.1),
            "d": lambda: self._align(+0.1, 0.0),
            "0": self.state.reset_view,
            "q": self._quit,
            "escape": self._quit,
        }

    def handle(self, key_name: str) -> bool:
        """Apply the action bound to key_name; returns True if handled."""
        action = self._actions.get(key_name.lower())
        if action is None:
            return False
        action()
        return True

    def _toggle_pause(self):
        self.state.paused = not self.state.paused

    def _restart(self):
        self.state.restart_request = True

    def _seek(self, dt: float):
        self.state.seek_request += dt

    def _toggle_loop(self):
        self.state.loop = not self.state.loop

    def _cycle_projection(self):
        i = PROJECTION_CYCLE.index(self.state.projection)
        self.state.projection = PROJECTION_CYCLE[(i + 1) % len(PROJECTION_CYCLE)]

    def _cycle_format(self):
        cyc = FORMAT_CYCLE
        fmt = self.state.stereo_format
        i = cyc.index(fmt) if fmt in cyc else -1
        self.state.stereo_format = cyc[(i + 1) % len(cyc)]

    def _swap(self):
        self.state.swap_eyes = not self.state.swap_eyes

    def _distance(self, d: float):
        self.state.screen_distance = max(0.5, self.state.screen_distance + d)

    def _size(self, d: float):
        self.state.screen_size = max(0.5, self.state.screen_size + d)

    def _align(self, dx: float, dy: float):
        self.state.align_x += dx
        self.state.align_y += dy

    def _quit(self):
        self.state.quit_request = True


def print_controls_help():
    print("VR Viewer Controls:")
    for key, desc in CONTROLS_HELP:
        print(f"  {key:12s} {desc}")


def create_help_overlay_texture(width: int = 400, height: int = 300):
    """PIL-rendered help panel as an RGBA numpy array (uploadable later)."""
    import numpy as np
    from PIL import Image, ImageDraw

    img = Image.new("RGBA", (width, height), (16, 16, 24, 220))
    draw = ImageDraw.Draw(img)
    draw.text((10, 6), "VR Video Controls", fill=(255, 255, 255, 255))
    y = 30
    for key, desc in CONTROLS_HELP:
        draw.text((10, y), f"{key}: {desc}", fill=(200, 200, 210, 255))
        y += 22
    return np.asarray(img, dtype=np.uint8)
