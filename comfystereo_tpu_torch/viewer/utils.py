"""Viewer lifecycle: availability probe, singleton launcher, shutdown.

Reference: native_viewer/utils.py:19-147 — a module-level viewer singleton
behind a lock, launched on a daemon thread; launch waits for a prior instance
to finish (<=10s) plus an OpenXR cleanup grace period; media updates go to the
running instance's queue.
"""
from __future__ import annotations

import threading
import time
from typing import Optional, Tuple

from . import constants
from .constants import MediaUpdate
from .core import PersistentNativeViewer

_viewer_lock = threading.Lock()
_global_viewer: Optional[PersistentNativeViewer] = None
_viewer_thread: Optional[threading.Thread] = None

PRIOR_INSTANCE_WAIT_S = 10.0
OPENXR_CLEANUP_WAIT_S = 3.0


def check_openxr_available() -> Tuple[bool, str]:
    """(available, message) — import probe plus runtime hint (ref :19-34)."""
    if not constants.PYOPENXR_AVAILABLE:
        return False, ("PyOpenXR/OpenGL/GLFW not installed. Install pyopenxr, "
                       "PyOpenGL, glfw (and a running OpenXR runtime such as "
                       "SteamVR or Monado) to enable native VR viewing.")
    return True, "OpenXR stack importable; runtime availability checked at launch."


def get_or_create_viewer() -> PersistentNativeViewer:
    """Return the running viewer, or start a fresh one on a daemon thread."""
    global _global_viewer, _viewer_thread
    with _viewer_lock:
        if _global_viewer is not None and _global_viewer.running:
            return _global_viewer
        # Wait out a previous instance that is still shutting down.
        if _viewer_thread is not None and _viewer_thread.is_alive():
            _global_viewer.stop()
            _viewer_thread.join(timeout=PRIOR_INSTANCE_WAIT_S)
            time.sleep(OPENXR_CLEANUP_WAIT_S if constants.PYOPENXR_AVAILABLE else 0.0)
        _global_viewer = PersistentNativeViewer()
        _viewer_thread = threading.Thread(
            target=_global_viewer.run, daemon=True, name="comfystereo-viewer")
        _viewer_thread.start()
        return _global_viewer


def launch_native_viewer(update: MediaUpdate) -> Tuple[bool, str]:
    """Check the runtime, start/reuse the viewer, enqueue the media update."""
    ok, msg = check_openxr_available()
    if not ok:
        return False, msg
    try:
        viewer = get_or_create_viewer()
    except Exception as e:  # pragma: no cover
        return False, f"Viewer failed to start: {e}"
    viewer.update_media(update)
    return True, "Viewer updated."


def stop_global_viewer():
    global _global_viewer
    with _viewer_lock:
        if _global_viewer is not None:
            _global_viewer.stop()
