"""Live GL smoke test of the port's viewer render path (the cases of
tests/test_viewer_gl.py, through tests/torch_gl_driver.py).

Drives the REAL shader/VAO/texture/draw pipeline — the code the unit tests
in test_viewer.py can only reach as extracted pure policies — under a
headless EGL context (mesa software GL in CI). Asserts actual pixels: each
eye of an SBS frame renders its own half of the texture, eye swap flips
them, MONO shows the full texture, and the background clear shows where no
media is loaded.

The GL work runs in a SUBPROCESS (tests/torch_gl_driver.py): mesa/llvmpipe
segfaults nondeterministically once torch, pygame, and jax CPU have all
been loaded into one process by earlier tests, and an in-process crash
would kill the whole pytest run. The driver prints sampled pixels as JSON;
skips cleanly when no EGL/GL stack exists in the image (the same
probe-don't-crash convention as check_openxr_available, reference
native_viewer/utils.py:19-34).
"""
import json
import os
import subprocess
import sys

import pytest

_DRIVER = os.path.join(os.path.dirname(__file__), "torch_gl_driver.py")


@pytest.fixture(scope="module")
def gl(tmp_path_factory):
    env = dict(os.environ)
    env["PYTHONPATH"] = (os.path.dirname(os.path.dirname(_DRIVER))
                         + os.pathsep + env.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, _DRIVER], capture_output=True,
                          text=True, timeout=600, env=env)
    if "NO_GL" in proc.stdout:
        pytest.skip("no headless EGL/OpenGL stack available")
    for line in proc.stdout.splitlines():
        if line.startswith("GL_RESULT "):
            return json.loads(line[len("GL_RESULT "):])
    pytest.fail(f"GL driver failed rc={proc.returncode}\n"
                f"stdout:\n{proc.stdout}\nstderr:\n{proc.stderr[-2000:]}")


def test_stereo_shader_crops_per_eye(gl):
    """Left eye samples the left (red) half, right eye the right (green)
    half — the in-shader SBS UV crop, on real rasterized pixels."""
    cl, cr = gl["sbs_left_center"], gl["sbs_right_center"]
    assert cl[0] > 200 and cl[1] < 50, cl
    assert cr[1] > 200 and cr[0] < 50, cr
    # The screen quad must not fill the whole view (corners = background).
    assert max(gl["sbs_corner"]) == 0


def test_eye_swap_uniform(gl):
    cl = gl["swapped_left_center"]
    assert cl[1] > 200 and cl[0] < 50, cl


def test_mono_format_full_frame(gl):
    """MONO renders the full texture: the view center lands on the seam
    between the red and green halves; a point left of center is red, right
    of center green."""
    lq, rq = gl["mono_left_q"], gl["mono_right_q"]
    assert lq[0] > 200 and rq[1] > 200, (lq, rq)


def test_background_without_media(gl):
    """No texture loaded -> clear to background color only."""
    bg = gl["background"]
    assert all(abs(a - b) <= 2 for a, b in zip(bg, [64, 128, 191])), bg
