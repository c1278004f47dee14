"""Native VR viewing subsystem (host-side shim).

The GPU produces stereo frames; this package pushes them to a headset via
OpenXR/OpenGL when the optional host stack (pyopenxr, PyOpenGL, glfw, cv2,
pygame, ffmpeg) is present. All projection/format/control/sync logic is pure
Python and works (and is tested) without any of those dependencies.
"""
from . import constants
from .constants import (  # noqa: F401
    FORMAT_CYCLE,
    FORMAT_SHADER_IDS,
    MediaUpdate,
    Projection,
    StereoFormat,
)
from .utils import (  # noqa: F401
    check_openxr_available,
    get_or_create_viewer,
    launch_native_viewer,
    stop_global_viewer,
)


def __getattr__(name: str):
    """The availability flags, probed on first read (`constants`)."""
    return getattr(constants, name)
