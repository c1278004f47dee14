"""VR viewer constants and availability probes.

Host-side subsystem: the GPU never touches the viewer, which stays a thin
host shim. Mirrors native_viewer/constants.py:5-73 in the reference:
optional-import probes (`PYOPENXR_AVAILABLE`, `CV2_AVAILABLE`,
`PYGAME_AVAILABLE`, each probed on first read), the stereo format enum, the
media update message, and the shader's format-integer mapping.
"""
from __future__ import annotations

import dataclasses
import enum
import importlib
import os
from typing import Optional

# Each flag names the optional modules it needs. A flag is probed (its
# modules imported) the first time it is read, not when the package is
# imported, so that importing the port imports none of them.
_PROBES = {
    "PYOPENXR_AVAILABLE": ("xr", "OpenGL.GL", "glfw"),
    "CV2_AVAILABLE": ("cv2",),
    "PYGAME_AVAILABLE": ("pygame",),
}


def _probe(flag: str) -> bool:
    os.environ.setdefault("PYGAME_HIDE_SUPPORT_PROMPT", "1")
    try:
        for mod in _PROBES[flag]:
            importlib.import_module(mod)
    except Exception:  # pragma: no cover - optional host deps
        return False
    return True


def __getattr__(name: str):
    if name in _PROBES:
        value = _probe(name)
        globals()[name] = value
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


class StereoFormat(enum.Enum):
    SBS = "side_by_side"
    OU = "over_under"
    ANAGLYPH = "anaglyph"
    MONO = "mono"
    SEPARATE = "separate"


# Integer codes consumed by the stereo fragment shader's uniform.
FORMAT_SHADER_IDS = {
    StereoFormat.SBS: 0,
    StereoFormat.OU: 1,
    StereoFormat.ANAGLYPH: 2,
    StereoFormat.MONO: 3,
    StereoFormat.SEPARATE: 4,
}

FORMAT_CYCLE = [StereoFormat.SBS, StereoFormat.OU, StereoFormat.MONO]


class Projection(enum.Enum):
    FLAT = "flat"
    CURVED = "curved"
    SPHERE_360 = "sphere360"
    DOME_180 = "dome180"


PROJECTION_CYCLE = [Projection.FLAT, Projection.CURVED,
                    Projection.SPHERE_360, Projection.DOME_180]


@dataclasses.dataclass
class MediaUpdate:
    """Message posted to the viewer thread's queue (reference MediaUpdate)."""

    image_path: Optional[str] = None
    video_path: Optional[str] = None
    stereo_format: StereoFormat = StereoFormat.SBS
    projection: Projection = Projection.FLAT
    swap_eyes: bool = False
    loop_video: bool = True
    audio_enabled: bool = True
    screen_size: float = 4.0
    screen_distance: float = 3.0
    background_color: tuple = (0.0, 0.0, 0.0)
