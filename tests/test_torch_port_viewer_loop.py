"""Stub-XR frame-loop orchestration test, on the port's viewer (the cases of
tests/test_viewer_loop.py).

The pure policy pieces of the viewer (tick cadence, A/V scheduling,
geometry keys, playback application) were already unit-tested, and the GL
draw path is EGL-smoke-tested in a subprocess — but the SEQUENCING of
`PersistentNativeViewer.run`/`_run_frames` (tick -> media load -> geometry
rebuild -> playback apply -> AV advance -> per-eye render -> teardown)
had never executed in a test. Here a fake `xr.ContextObject` + fake GL
module drive the REAL loop for a few frames.

Reference surface: native_viewer/core.py:413-540 (frame loop) and
:558-646 (teardown/restart).
"""
import sys
import types

import numpy as np
import pytest

from comfystereo_tpu_torch.viewer import constants as vconst
from comfystereo_tpu_torch.viewer import core as vcore
from comfystereo_tpu_torch.viewer.constants import MediaUpdate, Projection


# ---------------------------------------------------------------------------
# Fakes
# ---------------------------------------------------------------------------

class _FakeGLModule(types.ModuleType):
    """Any GL_* attribute is an int token; any gl* function returns 1."""

    def __getattr__(self, name):
        if name.startswith("GL_"):
            return 1
        return lambda *a, **k: 1


def _fake_gl_modules():
    gl = _FakeGLModule("OpenGL.GL")
    shaders = types.ModuleType("OpenGL.GL.shaders")
    shaders.compileShader = lambda src, kind: 1
    shaders.compileProgram = lambda vs, fs: 1
    gl.shaders = shaders
    pkg = types.ModuleType("OpenGL")
    pkg.GL = gl
    return {"OpenGL": pkg, "OpenGL.GL": gl, "OpenGL.GL.shaders": shaders}


class _Vec:
    def __init__(self, x=0.0, y=0.0, z=0.0, w=1.0):
        self.x, self.y, self.z, self.w = x, y, z, w


class _FakeView:
    def __init__(self, eye):
        self.pose = types.SimpleNamespace(
            position=_Vec(0.03 * (eye * 2 - 1), 1.6, 0.0),
            orientation=_Vec(0.0, 0.0, 0.0, 1.0))
        self.fov = types.SimpleNamespace(
            angle_left=-0.8, angle_right=0.7, angle_up=0.75,
            angle_down=-0.7)


class _FakeContextObject:
    """Stands in for xr.ContextObject: N frames, 2 eyes per frame."""

    frames_to_yield = 4
    instances = []

    def __init__(self, instance_create_info=None, **kw):
        self.instance_create_info = instance_create_info
        self.entered = self.exited = False
        _FakeContextObject.instances.append(self)

    def __enter__(self):
        self.entered = True
        return self

    def __exit__(self, *exc):
        self.exited = True
        return False

    def frame_loop(self):
        for i in range(self.frames_to_yield):
            yield types.SimpleNamespace(frame_index=i)

    def view_loop(self, frame_state):
        for eye in range(2):
            yield _FakeView(eye)


def _fake_xr_module():
    xr = types.ModuleType("xr")
    xr.ContextObject = _FakeContextObject
    xr.InstanceCreateInfo = lambda **kw: types.SimpleNamespace(**kw)
    xr.KHR_OPENGL_ENABLE_EXTENSION_NAME = "XR_KHR_opengl_enable"
    return xr


class _FakeProvider:
    """GLFWVisibleContextProvider stand-in: no control window."""

    created = []

    def __init__(self):
        self.window = None  # control-window render early-returns
        self.poll_calls = 0
        self.destroyed = False
        _FakeProvider.created.append(self)

    def poll_keys(self, keyboard_handler):
        self.poll_calls += 1

    def destroy(self):
        self.destroyed = True


@pytest.fixture
def stubbed_viewer(monkeypatch, tmp_path):
    """A viewer whose run() executes against fake XR/GL, plus an event log
    recording the orchestration order."""
    for name, mod in _fake_gl_modules().items():
        monkeypatch.setitem(sys.modules, name, mod)
    monkeypatch.setitem(sys.modules, "xr", _fake_xr_module())
    monkeypatch.setattr(vconst, "PYOPENXR_AVAILABLE", True)

    from comfystereo_tpu_torch.viewer import context as vctx

    monkeypatch.setattr(vctx, "GLFWVisibleContextProvider", _FakeProvider)
    _FakeContextObject.instances.clear()
    _FakeProvider.created.clear()

    viewer = vcore.PersistentNativeViewer()
    events = []

    def spy(name):
        orig = getattr(viewer, name)

        def wrapper(*a, **k):
            events.append(name)
            return orig(*a, **k)

        monkeypatch.setattr(viewer, name, wrapper)

    for name in ("tick", "_load_media_gl", "_setup_geometry_gl",
                 "_advance_video_gl", "_render_eye", "_release_gl",
                 "_teardown"):
        spy(name)

    from PIL import Image

    img_path = tmp_path / "frame.png"
    Image.fromarray(np.full((24, 48, 3), 128, np.uint8)).save(img_path)
    return viewer, events, str(img_path)


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------

def test_run_frames_orchestration_order(stubbed_viewer):
    """media enqueued -> first frame loads it, rebuilds geometry, advances
    AV, renders both eyes; subsequent frames skip reload; clean teardown."""
    viewer, events, img_path = stubbed_viewer
    viewer.update_media(MediaUpdate(image_path=img_path,
                                    projection=Projection.FLAT))
    viewer.run()

    # The XR session was created and exited cleanly.
    (ctx,) = _FakeContextObject.instances
    assert ctx.entered and ctx.exited
    assert "XR_KHR_opengl_enable" in \
        ctx.instance_create_info.enabled_extension_names

    # Frame 0 polls the queue (tick), loads media, rebuilds geometry for
    # the new aspect, then advances video and renders per eye — in order.
    i_tick = events.index("tick")
    i_load = events.index("_load_media_gl")
    i_geom = events.index("_setup_geometry_gl")
    i_adv = events.index("_advance_video_gl")
    i_eye = events.index("_render_eye")
    assert i_tick < i_load < i_geom < i_adv < i_eye

    # Media loads exactly once (no spurious reloads on frames 1..3);
    # geometry rebuilds once for the new media.
    assert events.count("_load_media_gl") == 1
    assert events.count("_setup_geometry_gl") == 1
    # 4 frames x 2 eyes.
    assert events.count("_render_eye") == 8
    assert events.count("tick") == 4
    # Keyboard polled every frame.
    (provider,) = _FakeProvider.created
    assert provider.poll_calls == 4

    # GL released before teardown; teardown ran; provider destroyed.
    assert events.index("_release_gl") < events.index("_teardown")
    assert provider.destroyed


def test_run_teardown_resets_for_restart(stubbed_viewer):
    """After run() ends, state is fully reset and a second run() works
    (reference core.py:604-646 'full state reset for clean restart')."""
    viewer, events, img_path = stubbed_viewer
    viewer.update_media(MediaUpdate(image_path=img_path))
    viewer.run()

    assert viewer.running is False
    assert not viewer.ready.is_set()
    assert viewer.current_media is None
    assert viewer.video_capture is None and viewer.audio is None
    assert viewer._frame_counter == 0 and viewer._geometry_key is None
    assert viewer.media_queue.empty()

    # Restart with new media: a fresh XR session + a fresh media load.
    events.clear()
    viewer.update_media(MediaUpdate(image_path=img_path, swap_eyes=True))
    viewer.run()
    assert len(_FakeContextObject.instances) == 2
    assert events.count("_load_media_gl") == 1
    assert events.count("_render_eye") == 8
    assert viewer.running is False  # torn down again


def test_quit_request_breaks_loop(stubbed_viewer, monkeypatch):
    """state.quit_request stops the loop before the frame budget."""
    viewer, events, img_path = stubbed_viewer
    monkeypatch.setattr(_FakeContextObject, "frames_to_yield", 1000)

    real_poll = _FakeProvider.poll_keys

    def quitting_poll(self, kb):
        real_poll(self, kb)
        if self.poll_calls >= 3:
            viewer.state.quit_request = True

    monkeypatch.setattr(_FakeProvider, "poll_keys", quitting_poll)
    viewer.update_media(MediaUpdate(image_path=img_path))
    viewer.run()
    # 3 polled frames rendered fully, the 4th hit the break before render.
    assert events.count("_render_eye") == 6
    assert viewer.running is False
    # State reset clears the quit flag for the next session.
    assert viewer.state.quit_request is False


def test_run_without_xr_raises(monkeypatch):
    monkeypatch.setattr(vconst, "PYOPENXR_AVAILABLE", False)
    viewer = vcore.PersistentNativeViewer()
    with pytest.raises(RuntimeError, match="PyOpenXR"):
        viewer.run()
