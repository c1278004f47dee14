"""GLFW visible control-window context provider.

Reference: native_viewer/context.py:11-105 — an OpenXR offscreen context
provider subclass that instead opens a small visible "VR Video Controls"
window (GL 4.1 core, floating, single-buffered) so keyboard input reaches the
viewer, with full GLFW teardown on exit. Requires glfw + OpenGL at runtime.
"""
from __future__ import annotations

from . import constants

WINDOW_TITLE = "VR Video Controls"
WINDOW_SIZE = (400, 300)

_KEY_NAMES = {}


class GLFWVisibleContextProvider:  # pragma: no cover - needs a display
    """Visible GLFW window owning the GL context used by OpenXR."""

    def __init__(self):
        if not constants.PYOPENXR_AVAILABLE:
            raise RuntimeError("glfw/OpenGL unavailable")
        import glfw

        if not glfw.init():
            raise RuntimeError("glfw.init() failed")
        glfw.window_hint(glfw.CONTEXT_VERSION_MAJOR, 4)
        glfw.window_hint(glfw.CONTEXT_VERSION_MINOR, 1)
        glfw.window_hint(glfw.OPENGL_PROFILE, glfw.OPENGL_CORE_PROFILE)
        glfw.window_hint(glfw.FLOATING, glfw.TRUE)
        glfw.window_hint(glfw.DOUBLEBUFFER, glfw.FALSE)
        self.window = glfw.create_window(*WINDOW_SIZE, WINDOW_TITLE, None, None)
        if self.window is None:
            glfw.terminate()
            raise RuntimeError("GLFW window creation failed")
        glfw.make_context_current(self.window)
        self._pressed = []
        glfw.set_key_callback(self.window, self._on_key)

    def _on_key(self, window, key, scancode, action, mods):
        import glfw

        if action != glfw.PRESS:
            return
        name = glfw.get_key_name(key, scancode)
        if name is None:
            name = {glfw.KEY_SPACE: "space", glfw.KEY_LEFT: "left",
                    glfw.KEY_RIGHT: "right", glfw.KEY_PAGE_UP: "page_up",
                    glfw.KEY_PAGE_DOWN: "page_down",
                    glfw.KEY_ESCAPE: "escape"}.get(key)
        if name is None:
            return
        if mods & glfw.MOD_SHIFT:
            name = "shift+" + name
        self._pressed.append(name)

    def poll_keys(self, keyboard_handler):
        import glfw

        glfw.poll_events()
        for name in self._pressed:
            keyboard_handler.handle(name)
        self._pressed.clear()

    # -- OpenXR context-provider protocol (xr.utils.gl expects these) --------

    def make_current(self):
        import glfw

        if self.window is not None:
            glfw.make_context_current(self.window)

    def done_current(self):
        import glfw

        glfw.make_context_current(None)

    def __enter__(self):
        self.make_current()
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.destroy()
        return False

    def destroy(self):
        import glfw

        if self.window is not None:
            glfw.destroy_window(self.window)
            self.window = None
        glfw.terminate()
