"""Headless EGL OpenGL context for offscreen viewer rendering.

The reference viewer only ever renders into an OpenXR-provided context
(native_viewer/core.py:374-389) or a visible GLFW window
(native_viewer/context.py:11-105), so its GL pipeline cannot run — or be
tested — without a headset attached. This module provides the third
option this package adds: a surfaceless EGL context (mesa software
rasterizer in CI) that makes the exact same shader/VAO/draw path drivable
headlessly — for the GL smoke tests and for offscreen stills (e.g.
rendering the projection surface to a PNG without any windowing system).

Gated at import-use time like every other viewer dependency: call
:func:`create_headless_context`; it returns ``None`` when EGL/OpenGL is
unavailable rather than raising.
"""
from __future__ import annotations

import os
from typing import Optional

# PyOpenGL picks its window-system binding at import; default is GLX which
# requires an X display. Selecting EGL must happen before `OpenGL` is first
# imported anywhere in the process. Harmless if another platform was
# already selected explicitly.
os.environ.setdefault("PYOPENGL_PLATFORM", "egl")


class HeadlessContext:
    """An initialized EGL display + current OpenGL core context.

    Offscreen rendering goes through user-created FBOs (the context is
    surfaceless where supported, else a 1x1 pbuffer); ``release()`` (or
    context-manager exit) tears down EGL state.
    """

    def __init__(self, display, context, surface):
        self._display = display
        self._context = context
        self._surface = surface
        self.released = False

    def release(self):
        if self.released:
            return
        from OpenGL import EGL

        EGL.eglMakeCurrent(self._display, EGL.EGL_NO_SURFACE,
                           EGL.EGL_NO_SURFACE, EGL.EGL_NO_CONTEXT)
        if self._surface is not None:
            EGL.eglDestroySurface(self._display, self._surface)
        EGL.eglDestroyContext(self._display, self._context)
        EGL.eglTerminate(self._display)
        self.released = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.release()
        return False


# Mesa's surfaceless platform renders with no display server at all —
# exactly the CI situation. Value from EGL_MESA_platform_surfaceless.
EGL_PLATFORM_SURFACELESS_MESA = 0x31DD


def _init_display(EGL):
    """First initializable display: surfaceless platform (no display
    server needed), then the default native display."""
    candidates = []
    if hasattr(EGL, "eglGetPlatformDisplayEXT"):
        candidates.append(lambda: EGL.eglGetPlatformDisplayEXT(
            EGL_PLATFORM_SURFACELESS_MESA, EGL.EGL_DEFAULT_DISPLAY, None))
    candidates.append(lambda: EGL.eglGetDisplay(EGL.EGL_DEFAULT_DISPLAY))
    for get in candidates:
        try:
            display = get()
            if display == EGL.EGL_NO_DISPLAY:
                continue
            maj, min_ = EGL.EGLint(), EGL.EGLint()
            if EGL.eglInitialize(display, maj, min_):
                return display
        except Exception:
            continue
    return None


def create_headless_context(major: int = 3, minor: int = 3
                            ) -> Optional[HeadlessContext]:
    """Create a current, headless OpenGL ``major.minor`` core context.

    Returns None when the EGL stack (or a capable driver) is absent, so
    callers/tests can skip gracefully — mirroring check_openxr_available's
    probe-don't-crash convention (reference native_viewer/utils.py:19-34).
    """
    try:
        import ctypes

        from OpenGL import EGL
    except Exception:
        return None
    try:
        display = _init_display(EGL)
        if display is None:
            return None
        if not EGL.eglBindAPI(EGL.EGL_OPENGL_API):
            EGL.eglTerminate(display)
            return None

        cfg_attribs = [
            EGL.EGL_SURFACE_TYPE, EGL.EGL_PBUFFER_BIT,
            EGL.EGL_RENDERABLE_TYPE, EGL.EGL_OPENGL_BIT,
            EGL.EGL_RED_SIZE, 8, EGL.EGL_GREEN_SIZE, 8,
            EGL.EGL_BLUE_SIZE, 8, EGL.EGL_ALPHA_SIZE, 8,
            EGL.EGL_DEPTH_SIZE, 16,
            EGL.EGL_NONE,
        ]
        cfg_attribs = (EGL.EGLint * len(cfg_attribs))(*cfg_attribs)
        configs = (EGL.EGLConfig * 1)()
        n = EGL.EGLint()
        if not EGL.eglChooseConfig(display, cfg_attribs, configs, 1,
                                   ctypes.byref(n)) or n.value < 1:
            EGL.eglTerminate(display)
            return None

        ctx_attribs = (EGL.EGLint * 5)(
            EGL.EGL_CONTEXT_MAJOR_VERSION, major,
            EGL.EGL_CONTEXT_MINOR_VERSION, minor,
            EGL.EGL_NONE)
        context = EGL.eglCreateContext(display, configs[0],
                                       EGL.EGL_NO_CONTEXT, ctx_attribs)
        if context == EGL.EGL_NO_CONTEXT:
            EGL.eglTerminate(display)
            return None

        # Surfaceless current if the driver allows; else a 1x1 pbuffer.
        surface = None
        if not EGL.eglMakeCurrent(display, EGL.EGL_NO_SURFACE,
                                  EGL.EGL_NO_SURFACE, context):
            pb_attribs = (EGL.EGLint * 5)(
                EGL.EGL_WIDTH, 1, EGL.EGL_HEIGHT, 1, EGL.EGL_NONE)
            surface = EGL.eglCreatePbufferSurface(display, configs[0],
                                                  pb_attribs)
            if surface == EGL.EGL_NO_SURFACE or not EGL.eglMakeCurrent(
                    display, surface, surface, context):
                EGL.eglDestroyContext(display, context)
                EGL.eglTerminate(display)
                return None
        return HeadlessContext(display, context, surface)
    except Exception:
        return None


def create_offscreen_fbo(width: int, height: int):
    """Color+depth FBO for offscreen eye renders; returns (fbo, color_tex).

    Requires a current context (e.g. from create_headless_context)."""
    from OpenGL import GL

    tex = GL.glGenTextures(1)
    GL.glBindTexture(GL.GL_TEXTURE_2D, tex)
    GL.glTexImage2D(GL.GL_TEXTURE_2D, 0, GL.GL_RGBA8, width, height, 0,
                    GL.GL_RGBA, GL.GL_UNSIGNED_BYTE, None)
    GL.glTexParameteri(GL.GL_TEXTURE_2D, GL.GL_TEXTURE_MIN_FILTER,
                       GL.GL_NEAREST)
    GL.glTexParameteri(GL.GL_TEXTURE_2D, GL.GL_TEXTURE_MAG_FILTER,
                       GL.GL_NEAREST)
    rbo = GL.glGenRenderbuffers(1)
    GL.glBindRenderbuffer(GL.GL_RENDERBUFFER, rbo)
    GL.glRenderbufferStorage(GL.GL_RENDERBUFFER, GL.GL_DEPTH_COMPONENT16,
                             width, height)
    fbo = GL.glGenFramebuffers(1)
    GL.glBindFramebuffer(GL.GL_FRAMEBUFFER, fbo)
    GL.glFramebufferTexture2D(GL.GL_FRAMEBUFFER, GL.GL_COLOR_ATTACHMENT0,
                              GL.GL_TEXTURE_2D, tex, 0)
    GL.glFramebufferRenderbuffer(GL.GL_FRAMEBUFFER, GL.GL_DEPTH_ATTACHMENT,
                                 GL.GL_RENDERBUFFER, rbo)
    status = GL.glCheckFramebufferStatus(GL.GL_FRAMEBUFFER)
    if status != GL.GL_FRAMEBUFFER_COMPLETE:
        raise RuntimeError(f"FBO incomplete: 0x{status:x}")
    return fbo, tex


def read_fbo_pixels(width: int, height: int):
    """Read the bound FBO into an [H, W, 4] uint8 array (top row first)."""
    import numpy as np
    from OpenGL import GL

    data = GL.glReadPixels(0, 0, width, height, GL.GL_RGBA,
                           GL.GL_UNSIGNED_BYTE)
    arr = np.frombuffer(data, dtype=np.uint8).reshape(height, width, 4)
    return arr[::-1]  # GL's origin is bottom-left
