"""The port's VR viewer (comfystereo_tpu_torch/viewer): the cases of
tests/test_viewer.py against the port's copy, plus its geometry and math3d
arrays against the JAX package's (bit-equal: the same numpy code), the
native nodes' contracts against the JAX nodes', and the lazy probing of
the viewer's optional dependencies."""
import numpy as np
import pytest

from comfystereo_tpu_torch.viewer import (
    MediaUpdate, Projection, StereoFormat, check_openxr_available)
from comfystereo_tpu_torch.viewer import audio, controls, core, geometry, media


# --- geometry ---------------------------------------------------------------

def test_sphere_mesh_shape_and_radius():
    verts, idx = geometry.create_sphere_mesh(segments=12, rings=8, radius=5.0)
    assert verts.shape == (13 * 9, 5)
    r = np.linalg.norm(verts[:, :3], axis=1)
    np.testing.assert_allclose(r, 5.0, atol=1e-4)
    assert idx.max() < len(verts)
    assert idx.shape[1] == 3
    u, v = verts[:, 3], verts[:, 4]
    assert u.min() >= 0 and u.max() <= 1 and v.min() >= 0 and v.max() <= 1


def test_flat_screen_quad():
    verts, idx = geometry.create_flat_screen(width=4.0, aspect=2.0,
                                             distance=3.0)
    assert verts.shape == (4, 5)
    assert idx.shape == (2, 3)
    np.testing.assert_allclose(verts[:, 2], -3.0)
    assert verts[:, 0].max() - verts[:, 0].min() == pytest.approx(4.0)
    assert verts[:, 1].max() - verts[:, 1].min() == pytest.approx(2.0)


def test_curved_screen_curvature():
    verts, _ = geometry.create_curved_screen(curve=0.4, segments=10, rows=4)
    z = verts[:, 2]
    assert z.max() - z.min() > 0.01  # actually curved
    u = verts[:, 3]
    assert u.min() == pytest.approx(0) and u.max() == pytest.approx(1)


def test_dome_hemisphere():
    verts, _ = geometry.create_dome_180(segments=8, rings=8, radius=2.0)
    assert (verts[:, 2] <= 1e-5).all()  # front hemisphere only


def test_mesh_for_projection_dispatch():
    for proj in Projection:
        verts, idx = geometry.mesh_for_projection(proj)
        assert verts.shape[1] == 5 and idx.shape[1] == 3


# --- media ------------------------------------------------------------------

def test_aspect_ratio_per_eye():
    assert media.calculate_aspect_ratio(3840, 1080, StereoFormat.SBS) == \
        pytest.approx(1920 / 1080)
    assert media.calculate_aspect_ratio(1920, 2160, StereoFormat.OU) == \
        pytest.approx(1920 / 1080)
    assert media.calculate_aspect_ratio(1920, 1080, StereoFormat.MONO) == \
        pytest.approx(1920 / 1080)


# --- audio ------------------------------------------------------------------

def test_extraction_command_copy_vs_reencode():
    argv, out = audio.extraction_command("v.mp4", "mp3", "/tmp/x")
    assert "copy" in argv and out.endswith(".mp3")
    argv, out = audio.extraction_command("v.mp4", "aac", "/tmp/x")
    assert "libvorbis" in argv and out.endswith(".ogg")
    assert "-q:a" in argv and argv[argv.index("-q:a") + 1] == "6"


# --- controls ---------------------------------------------------------------

def test_keyboard_state_machine():
    st = controls.ViewerState()
    kb = controls.KeyboardHandler(st)
    assert kb.handle("space") and st.paused
    kb.handle("p")
    assert st.projection == Projection.CURVED
    kb.handle("shift+s")
    assert st.stereo_format == StereoFormat.OU
    kb.handle("e")
    assert st.swap_eyes
    kb.handle("page_up")
    assert st.screen_distance == pytest.approx(3.5)
    kb.handle("w")
    kb.handle("d")
    assert (st.align_x, st.align_y) == (pytest.approx(0.1), pytest.approx(0.1))
    kb.handle("0")
    assert st.screen_distance == 3.0 and st.align_x == 0.0
    assert not kb.handle("zz")  # unknown key
    kb.handle("escape")
    assert st.quit_request


def test_help_overlay_texture():
    tex = controls.create_help_overlay_texture()
    assert tex.shape == (300, 400, 4)
    assert tex[..., 3].max() > 0


# --- A/V sync + queue -------------------------------------------------------

def test_av_sync_policy():
    assert core.schedule_video_frame(0.0, 30, 0) == (0, "hold")
    assert core.schedule_video_frame(1.0, 30, 29) == (30, "advance")
    assert core.schedule_video_frame(2.0, 30, 10) == (60, "seek")


def test_viewer_queue_drains_to_latest():
    v = core.PersistentNativeViewer()
    v.update_media(MediaUpdate(image_path="a.png"))
    v.update_media(MediaUpdate(image_path="b.png",
                               stereo_format=StereoFormat.OU))
    assert v.check_for_updates()
    assert v.current_media.image_path == "b.png"
    assert v.state.stereo_format == StereoFormat.OU
    assert not v.check_for_updates()  # queue empty now


def test_viewer_tick_polls_first_frame_then_every_interval():
    v = core.PersistentNativeViewer()
    v.update_media(MediaUpdate(image_path="x.png"))
    changed = [v.tick() for _ in range(core.MEDIA_POLL_INTERVAL + 1)]
    # Polls immediately on frame 0 (reference core.py:419-421)...
    assert changed[0] is not None
    # ...then not again until MEDIA_POLL_INTERVAL frames later.
    v.update_media(MediaUpdate(image_path="y.png"))
    assert all(c is None for c in changed[1:core.MEDIA_POLL_INTERVAL])
    assert changed[core.MEDIA_POLL_INTERVAL] is None  # queued after the poll
    for _ in range(core.MEDIA_POLL_INTERVAL - 1):
        assert v.tick() is None
    assert v.tick().image_path == "y.png"


# --- render-loop pure logic (math, geometry params, playback state) ----------

class FakeCapture:
    """Stands in for media.VideoCapture in headset-free tests."""

    def __init__(self, fps=30.0, frame_count=300):
        self.fps = fps
        self.frame_count = frame_count
        self.current_frame = 0
        self.calls = []

    def seek(self, idx):
        self.current_frame = max(0, idx)
        self.calls.append(("seek", idx))

    def restart(self):
        self.seek(0)
        self.calls.append(("restart",))


class FakeAudio:
    def __init__(self):
        self.calls = []

    def seek(self, seconds):
        self.calls.append(("seek", seconds))


def test_projection_matrix_symmetric_fov():
    from comfystereo_tpu_torch.viewer import math3d

    a = np.pi / 4
    proj = math3d.projection_from_fov(-a, a, a, -a, near=0.1, far=100.0)
    # Symmetric 90-degree FOV: focal terms are 1, no off-axis shear.
    assert proj[0, 0] == pytest.approx(1.0)
    assert proj[1, 1] == pytest.approx(1.0)
    assert proj[0, 2] == pytest.approx(0.0) and proj[1, 2] == pytest.approx(0.0)
    # A point on the near plane maps to clip z=-1, far plane to z=+1.
    for z, expect in [(-0.1, -1.0), (-100.0, 1.0)]:
        clip = proj @ np.array([0, 0, z, 1.0])
        assert clip[2] / clip[3] == pytest.approx(expect, abs=1e-5)


def test_projection_matrix_asymmetric_offaxis():
    from comfystereo_tpu_torch.viewer import math3d

    proj = math3d.projection_from_fov(-0.9, 0.5, 0.7, -0.6)
    assert proj[0, 2] != 0.0 and proj[1, 2] != 0.0  # off-axis terms present


def test_view_from_pose_inverts_rigid_body():
    from comfystereo_tpu_torch.viewer import math3d

    # 90-degree rotation about Y plus a translation.
    q = (0.0, np.sin(np.pi / 4), 0.0, np.cos(np.pi / 4))
    t = (1.0, 2.0, 3.0)
    view = math3d.view_from_pose(t, q)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = math3d.quat_to_mat3(q)
    pose[:3, 3] = t
    np.testing.assert_allclose(view @ pose, np.eye(4), atol=1e-5)
    # The eye position maps to the origin in view space.
    np.testing.assert_allclose((view @ np.array([1, 2, 3, 1.0]))[:3], 0,
                               atol=1e-5)


def test_quat_identity_and_mvp():
    from comfystereo_tpu_torch.viewer import math3d

    np.testing.assert_allclose(math3d.quat_to_mat3((0, 0, 0, 1)), np.eye(3),
                               atol=1e-7)
    p = math3d.projection_from_fov(-0.7, 0.7, 0.7, -0.7)
    v = math3d.view_from_pose((0, 0, 0), (0, 0, 0, 1))
    np.testing.assert_allclose(math3d.mvp(p, v), p @ v, atol=1e-6)
    np.testing.assert_allclose(math3d.mvp(p, v, np.eye(4, dtype=np.float32)),
                               p @ v, atol=1e-6)


def test_geometry_spec_consumes_all_view_state():
    st = controls.ViewerState()
    st.screen_size, st.screen_distance = 5.0, 2.0
    st.align_x, st.align_y = 0.3, -0.2
    proj, kwargs = core.geometry_spec(st, aspect=16 / 9)
    assert proj == Projection.FLAT
    assert kwargs["width"] == 5.0 and kwargs["distance"] == 2.0
    assert kwargs["x_offset"] == 0.3 and kwargs["y_offset"] == -0.2
    st.projection = Projection.DOME_180
    _, kwargs = core.geometry_spec(st, aspect=1.0)
    assert kwargs == {"radius": 4.0}
    st.projection = Projection.SPHERE_360
    _, kwargs = core.geometry_spec(st, aspect=1.0)
    assert kwargs == {"radius": core.SPHERE_RADIUS}


def test_geometry_key_changes_on_keyboard_actions():
    st = controls.ViewerState()
    kb = controls.KeyboardHandler(st)
    k0 = core.geometry_key(st, 16 / 9)
    assert core.geometry_key(st, 16 / 9) == k0  # stable
    for key in ("page_up", "equal", "w", "p"):
        prev = core.geometry_key(st, 16 / 9)
        kb.handle(key)
        assert core.geometry_key(st, 16 / 9) != prev, key
    assert core.geometry_key(st, 16 / 9) != core.geometry_key(st, 4 / 3)


def test_build_projection_mesh_all_projections():
    st = controls.ViewerState()
    for proj in Projection:
        st.projection = proj
        verts, idx = core.build_projection_mesh(st, aspect=16 / 9)
        assert verts.shape[1] == 5 and idx.shape[1] == 3


def test_curved_screen_alignment_offsets():
    v0, _ = geometry.create_curved_screen(x_offset=0.0, y_offset=0.0)
    v1, _ = geometry.create_curved_screen(x_offset=0.5, y_offset=-0.25)
    np.testing.assert_allclose(v1[:, 0] - v0[:, 0], 0.5, atol=1e-6)
    np.testing.assert_allclose(v1[:, 1] - v0[:, 1], -0.25, atol=1e-6)
    np.testing.assert_allclose(v1[:, 3:], v0[:, 3:], atol=1e-6)  # UVs fixed


def test_apply_playback_state_seek_and_restart():
    st = controls.ViewerState()
    cap = FakeCapture(fps=30.0, frame_count=300)
    aud = FakeAudio()
    cap.current_frame = 150
    st.seek_request = +5.0
    actions = core.apply_playback_state(st, cap, aud)
    assert actions == ["seek:299"]  # 150 + 150 clamped to frame_count-1
    assert st.seek_request == 0.0
    assert ("seek", 299 / 30.0) in aud.calls
    st.seek_request = -1000.0
    assert core.apply_playback_state(st, cap, aud) == ["seek:0"]
    st.restart_request = True
    st.seek_request = 2.0  # restart wins and clears pending seeks
    assert core.apply_playback_state(st, cap, aud) == ["restart"]
    assert cap.current_frame == 0 and st.seek_request == 0.0


def test_apply_playback_state_without_capture_clears_requests():
    st = controls.ViewerState()
    st.seek_request, st.restart_request = 5.0, True
    assert core.apply_playback_state(st, None, None) == []
    assert st.seek_request == 0.0 and not st.restart_request


def test_video_frame_action_wall_clock_fallback():
    # No audio clock: advance only after a frame period has elapsed.
    assert core.video_frame_action(None, 10.0, 10.0, 30.0, 7) == (7, "hold")
    assert core.video_frame_action(None, 10.05, 10.0, 30.0, 7) == (8, "advance")
    # Audio clock present: defer to schedule_video_frame.
    assert core.video_frame_action(2.0, 0.0, 0.0, 30.0, 10) == (60, "seek")


def test_end_of_video_action():
    assert core.end_of_video_action(True) == "restart"
    assert core.end_of_video_action(False) == "hold"


def test_teardown_resets_for_clean_restart():
    v = core.PersistentNativeViewer()
    v.update_media(MediaUpdate(image_path="x.png"))
    v.tick()
    v.state.screen_distance = 9.0
    v._frame_counter = 55
    v._teardown()
    assert v.current_media is None and v.media_queue.empty()
    assert v.state.screen_distance == 3.0  # fresh ViewerState
    assert v.keyboard.state is v.state  # keyboard rebound to the new state
    assert not v.running and v._frame_counter == 0


# --- availability + nodes ---------------------------------------------------

def test_openxr_probe_graceful():
    ok, msg = check_openxr_available()
    assert isinstance(ok, bool) and isinstance(msg, str)
    assert not ok  # this image has no OpenXR stack


def test_vr_status_node():
    from comfystereo_tpu_torch.nodes.native_nodes import NativeVRStatus

    (status,) = NativeVRStatus().get_status()
    assert "OpenXR" in status


def test_image_viewer_node_passthrough(tmp_path):
    from comfystereo_tpu_torch.nodes.native_nodes import (NativeStereoImageViewer,
                                                          save_hashed_png)

    img = np.random.default_rng(0).uniform(0, 1, (1, 8, 8, 3)).astype(np.float32)
    (out,) = NativeStereoImageViewer().view_stereo_native(img)
    assert out is img
    p1 = save_hashed_png(img[0])
    p2 = save_hashed_png(img[0])
    assert p1 == p2  # content-hashed reuse


# --- against the JAX package -------------------------------------------------

def test_geometry_arrays_equal_jax():
    from comfystereo_tpu.viewer import geometry as jgeometry
    from comfystereo_tpu.viewer.constants import Projection as JProjection

    cases = [("create_sphere_mesh", dict(segments=12, rings=8, radius=5.0)),
             ("create_flat_screen", dict(width=4.0, aspect=2.0, distance=3.0)),
             ("create_curved_screen", dict(curve=0.4, segments=10, rows=4,
                                           x_offset=0.5, y_offset=-0.25)),
             ("create_dome_180", dict(segments=8, rings=8, radius=2.0))]
    for name, kw in cases:
        for got, want in zip(getattr(geometry, name)(**kw), getattr(jgeometry, name)(**kw)):
            assert got.dtype == want.dtype, name
            np.testing.assert_array_equal(got, want)
    for proj, jproj in zip(Projection, JProjection):
        assert proj.value == jproj.value
        for got, want in zip(geometry.mesh_for_projection(proj),
                             jgeometry.mesh_for_projection(jproj)):
            np.testing.assert_array_equal(got, want)


def test_math3d_arrays_equal_jax():
    from comfystereo_tpu.viewer import math3d as jmath3d
    from comfystereo_tpu_torch.viewer import math3d

    q = (0.1, np.sin(np.pi / 5), -0.2, np.cos(np.pi / 5))
    for name, args in [("projection_from_fov", (-0.9, 0.5, 0.7, -0.6)),
                       ("view_from_pose", ((1.0, 2.0, 3.0), q)),
                       ("quat_to_mat3", (q,))]:
        np.testing.assert_array_equal(getattr(math3d, name)(*args),
                                      getattr(jmath3d, name)(*args))
    p = math3d.projection_from_fov(-0.7, 0.7, 0.7, -0.7)
    v = math3d.view_from_pose((0, 1.2, 0), (0, 0, 0, 1))
    np.testing.assert_array_equal(math3d.mvp(p, v), jmath3d.mvp(p, v))


def test_controls_and_constants_equal_jax():
    from comfystereo_tpu.viewer import constants as jconst
    from comfystereo_tpu.viewer import controls as jcontrols
    from comfystereo_tpu_torch.viewer import constants

    assert [f.value for f in constants.FORMAT_CYCLE] == [f.value for f in jconst.FORMAT_CYCLE]
    assert {k.value: v for k, v in constants.FORMAT_SHADER_IDS.items()} == \
        {k.value: v for k, v in jconst.FORMAT_SHADER_IDS.items()}
    for flag in ("PYOPENXR_AVAILABLE", "CV2_AVAILABLE", "PYGAME_AVAILABLE"):
        assert getattr(constants, flag) == getattr(jconst, flag), flag
    np.testing.assert_array_equal(controls.create_help_overlay_texture(),
                                  jcontrols.create_help_overlay_texture())


def test_native_node_contracts_equal_jax():
    from comfystereo_tpu.nodes import native_nodes as jnodes
    from comfystereo_tpu_torch.nodes import native_nodes as nodes

    assert nodes.NODE_DISPLAY_NAME_MAPPINGS == jnodes.NODE_DISPLAY_NAME_MAPPINGS
    assert sorted(nodes.NODE_CLASS_MAPPINGS) == sorted(jnodes.NODE_CLASS_MAPPINGS)
    for name, cls in nodes.NODE_CLASS_MAPPINGS.items():
        jcls = jnodes.NODE_CLASS_MAPPINGS[name]
        assert cls.INPUT_TYPES() == jcls.INPUT_TYPES(), name
        for attr in ("RETURN_TYPES", "RETURN_NAMES", "FUNCTION", "CATEGORY"):
            assert getattr(cls, attr) == getattr(jcls, attr), (name, attr)
        assert getattr(cls, "OUTPUT_NODE", False) == getattr(jcls, "OUTPUT_NODE", False)
    img = np.random.default_rng(1).uniform(0, 1, (8, 8, 3)).astype(np.float32)
    assert nodes.save_hashed_png(img) == jnodes.save_hashed_png(img)


def test_image_viewer_node_passes_torch_tensors_through(capsys):
    import torch
    from comfystereo_tpu_torch.nodes.native_nodes import (NativeStereoImageViewer,
                                                          first_frame)

    img = torch.rand((2, 8, 8, 3), generator=torch.Generator().manual_seed(0))
    bf = img.bfloat16()
    (out,) = NativeStereoImageViewer().view_stereo_native(bf)
    assert out is bf
    assert "VR viewer unavailable" in capsys.readouterr().out
    frame = first_frame(bf)
    assert frame.dtype == np.float32 and frame.shape == (8, 8, 3)
    np.testing.assert_array_equal(frame, bf[0].float().numpy())


def test_vr_status_reports_cuda():
    from comfystereo_tpu_torch.nodes.native_nodes import NativeVRStatus

    (status,) = NativeVRStatus().get_status()
    assert "CUDA device:" in status and "OpenXR" in status


def test_importing_the_port_probes_no_optional_dependency():
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys, comfystereo_tpu_torch as c, torch\n"
            "assert c.VR_NODES_AVAILABLE\n"
            "bad = [m for m in ('cv2', 'pygame', 'xr', 'OpenGL', 'glfw') if m in sys.modules]\n"
            "assert not bad, bad\n"
            "assert not torch.cuda.is_initialized()\n"
            "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True,
                         text=True, timeout=120, env=dict(os.environ, PYTHONPATH=repo))
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
