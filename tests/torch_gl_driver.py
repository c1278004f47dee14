"""Subprocess driver for the live GL smoke tests of the port's viewer (the
copy of tests/gl_driver.py that imports comfystereo_tpu_torch).

Runs the viewer's REAL shader/VAO/texture/draw pipeline under a headless
EGL context in a CLEAN interpreter and prints one JSON line of sampled
pixels. test_viewer_gl.py executes this file in a subprocess so that a
segfault in the native GL stack (mesa/llvmpipe is fragile once torch,
pygame, and jax have all been loaded into the same process by earlier
tests) fails only the GL tests instead of killing the whole pytest run.

Prints NO_GL when no EGL/OpenGL stack exists (skip upstream).
"""
import json
import math
import sys
import types

import numpy as np


def _fake_view():
    """An xr.View stand-in: identity pose at eye height, symmetric 90° FOV
    (the math3d adapters only read .pose.position/.orientation and
    .fov.angle_*)."""
    from comfystereo_tpu_torch.viewer.geometry import EYE_HEIGHT

    return types.SimpleNamespace(
        pose=types.SimpleNamespace(
            position=types.SimpleNamespace(x=0.0, y=EYE_HEIGHT, z=0.0),
            orientation=types.SimpleNamespace(x=0.0, y=0.0, z=0.0, w=1.0)),
        fov=types.SimpleNamespace(
            angle_left=-math.pi / 4, angle_right=math.pi / 4,
            angle_up=math.pi / 4, angle_down=-math.pi / 4))


W, H = 96, 64


def main():
    from comfystereo_tpu_torch.viewer.headless import (
        create_headless_context, create_offscreen_fbo, read_fbo_pixels)

    ctx = create_headless_context()
    if ctx is None:
        print("NO_GL")
        return 0

    from OpenGL import GL

    from comfystereo_tpu_torch.viewer import geometry, rendering
    from comfystereo_tpu_torch.viewer.constants import StereoFormat
    from comfystereo_tpu_torch.viewer.core import PersistentNativeViewer

    # A viewer wired up exactly as _run_frames would: compiled stereo
    # program, flat-screen VAO, and an SBS texture whose left half is pure
    # red and right half pure green.
    viewer = PersistentNativeViewer()
    viewer._program = rendering.create_stereo_shaders()
    verts, idx = geometry.create_flat_screen()
    viewer._vao, viewer._vbo, viewer._ebo = rendering.setup_vao_vbo(
        verts, idx)
    viewer._index_count = int(idx.size)

    sbs = np.zeros((32, 64, 3), np.uint8)
    sbs[:, :32, 0] = 255   # left eye: red
    sbs[:, 32:, 1] = 255   # right eye: green
    tex = GL.glGenTextures(1)
    GL.glBindTexture(GL.GL_TEXTURE_2D, tex)
    GL.glTexImage2D(GL.GL_TEXTURE_2D, 0, GL.GL_RGB8, 64, 32, 0, GL.GL_RGB,
                    GL.GL_UNSIGNED_BYTE, sbs)
    GL.glTexParameteri(GL.GL_TEXTURE_2D, GL.GL_TEXTURE_MIN_FILTER,
                       GL.GL_NEAREST)
    GL.glTexParameteri(GL.GL_TEXTURE_2D, GL.GL_TEXTURE_MAG_FILTER,
                       GL.GL_NEAREST)
    viewer._texture = tex

    fbo, _ = create_offscreen_fbo(W, H)
    GL.glBindFramebuffer(GL.GL_FRAMEBUFFER, fbo)
    GL.glViewport(0, 0, W, H)

    def center(eye):
        viewer._render_eye(_fake_view(), eye)
        frame = read_fbo_pixels(W, H)
        return frame[H // 2, W // 2, :3], frame

    out = {}
    center_l, frame_l = center(0)
    center_r, _ = center(1)
    out["sbs_left_center"] = center_l.tolist()
    out["sbs_right_center"] = center_r.tolist()
    out["sbs_corner"] = frame_l[0, 0, :3].tolist()

    viewer.state.swap_eyes = True
    swapped_l, _ = center(0)
    viewer.state.swap_eyes = False
    out["swapped_left_center"] = swapped_l.tolist()

    viewer.state.stereo_format = StereoFormat.MONO
    _, frame = center(0)
    viewer.state.stereo_format = StereoFormat.SBS
    out["mono_left_q"] = frame[H // 2, int(W * 0.35), :3].tolist()
    out["mono_right_q"] = frame[H // 2, int(W * 0.65), :3].tolist()

    # Background clear with no media loaded.
    bg_viewer = PersistentNativeViewer()
    bg_viewer.background_color = (0.25, 0.5, 0.75)
    fbo2, _ = create_offscreen_fbo(16, 16)
    GL.glBindFramebuffer(GL.GL_FRAMEBUFFER, fbo2)
    GL.glViewport(0, 0, 16, 16)
    bg_viewer._render_eye(_fake_view(), eye=0)
    out["background"] = read_fbo_pixels(16, 16)[0, 0, :3].tolist()

    ctx.release()
    print("GL_RESULT " + json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
