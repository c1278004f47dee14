"""Persistent VR viewer: media queue, A/V sync, and the OpenXR render loop.

Reference: native_viewer/core.py:41-659 — a daemon-thread viewer that owns an
OpenXR session, polls a thread-safe media queue every 30 frames, rebuilds
geometry on media/projection change, schedules video frames from the audio
clock (seek when >3 frames behind, wall-clock fallback otherwise), renders per
eye with headset pose matrices, draws a help overlay in the control window,
and resets state fully on shutdown for clean restarts.

The GL/XR calls require a headset runtime and are gated; every decision the
loop makes — matrices (math3d), geometry parameters (geometry_spec), playback
control application (apply_playback_state), A/V frame scheduling
(schedule_video_frame / video_frame_action), loop-at-end policy — is pure
Python and covered by tests.
"""
from __future__ import annotations

import gc
import queue
import threading
import time
from typing import List, Optional, Tuple

from .audio import AudioPlayer
from . import constants
from .constants import MediaUpdate, Projection
from .controls import KeyboardHandler, ViewerState
from .media import VideoCapture, calculate_aspect_ratio

MEDIA_POLL_INTERVAL = 30       # frames between media-queue polls (ref :421)
AV_SEEK_THRESHOLD = 3          # frames behind audio before seeking (ref :437-467)
SPHERE_RADIUS = 100.0          # 360-degree sphere radius (ref :134)
CURVE_AMOUNT = 0.4             # curved-screen arc strength (ref :123)


def schedule_video_frame(audio_pos_s: float, fps: float, current_frame: int):
    """A/V sync policy: (target_frame, action) where action is
    'hold' | 'advance' | 'seek' (reference :437-467)."""
    target = int(audio_pos_s * fps)
    if target <= current_frame:
        return current_frame, "hold"
    if target - current_frame > AV_SEEK_THRESHOLD:
        return target, "seek"
    return current_frame + 1, "advance"


def video_frame_action(audio_pos_s: Optional[float], now_s: float,
                       last_frame_time_s: float, fps: float,
                       current_frame: int):
    """Frame scheduling with wall-clock fallback when no audio clock exists
    (reference :459-467). Returns (target_frame, action)."""
    if audio_pos_s is not None:
        return schedule_video_frame(audio_pos_s, fps, current_frame)
    if now_s - last_frame_time_s >= 1.0 / max(fps, 1e-6):
        return current_frame + 1, "advance"
    return current_frame, "hold"


def geometry_spec(state: ViewerState, aspect: float):
    """Projection-surface builder parameters for the current view state
    (reference create_geometry, :106-134). Every ``ViewerState`` field the
    keyboard can change (projection, screen_size, screen_distance, align_x/y)
    feeds in here, so a key press takes effect on the next geometry rebuild."""
    p = state.projection
    if p == Projection.FLAT:
        return p, dict(width=state.screen_size, aspect=aspect,
                       distance=state.screen_distance,
                       x_offset=state.align_x, y_offset=state.align_y)
    if p == Projection.CURVED:
        return p, dict(width=state.screen_size, aspect=aspect,
                       distance=state.screen_distance, curve=CURVE_AMOUNT,
                       x_offset=state.align_x, y_offset=state.align_y)
    if p == Projection.DOME_180:
        return p, dict(radius=state.screen_distance * 2.0)
    return p, dict(radius=SPHERE_RADIUS)


def geometry_key(state: ViewerState, aspect: float) -> Tuple:
    """Hashable fingerprint of everything the mesh depends on; the loop
    rebuilds geometry whenever this changes (reference geometry_needs_update)."""
    proj, kwargs = geometry_spec(state, aspect)
    return (proj,) + tuple(sorted((k, round(float(v), 6))
                                  for k, v in kwargs.items()))


def build_projection_mesh(state: ViewerState, aspect: float):
    """(vertices, indices) for the current projection and view settings."""
    from .geometry import mesh_for_projection

    proj, kwargs = geometry_spec(state, aspect)
    return mesh_for_projection(proj, **kwargs)


def apply_playback_state(state: ViewerState, capture: Optional[VideoCapture],
                         audio: Optional[AudioPlayer]) -> List[str]:
    """Consume pending restart/seek requests from the keyboard state and apply
    them to the video capture + audio clock (reference controls semantics).
    Returns the list of actions performed (for tests/diagnostics)."""
    actions: List[str] = []
    if capture is None:
        state.seek_request = 0.0
        state.restart_request = False
        return actions
    if state.restart_request:
        state.restart_request = False
        state.seek_request = 0.0
        capture.restart()
        if audio is not None:
            audio.seek(0.0)
        actions.append("restart")
    if state.seek_request:
        dt, state.seek_request = state.seek_request, 0.0
        target = capture.current_frame + int(round(dt * capture.fps))
        target = max(0, target)
        if capture.frame_count > 0:
            target = min(target, capture.frame_count - 1)
        capture.seek(target)
        if audio is not None:
            audio.seek(target / max(capture.fps, 1e-6))
        actions.append(f"seek:{target}")
    return actions


def end_of_video_action(loop: bool) -> str:
    """Policy when capture.read() hits end-of-stream (reference loop flag)."""
    return "restart" if loop else "hold"


class PersistentNativeViewer:
    """Viewer instance living on a daemon thread; media updates arrive
    through a thread-safe queue (update_media)."""

    def __init__(self):
        self.media_queue: "queue.Queue[MediaUpdate]" = queue.Queue()
        self.state = ViewerState()
        self.keyboard = KeyboardHandler(self.state)
        self.running = False
        self.ready = threading.Event()
        self.audio: Optional[AudioPlayer] = None
        self.current_media: Optional[MediaUpdate] = None
        self.video_capture: Optional[VideoCapture] = None
        self.background_color = (0.0, 0.0, 0.0)
        self._frame_counter = 0
        self._video_frame = 0
        self._last_frame_time = 0.0
        self._was_paused = False
        # GL resources (populated only inside run())
        self._texture = None
        self._aspect = 16.0 / 9.0
        self._geometry_key = None
        self._vao = self._vbo = self._ebo = None
        self._index_count = 0
        self._program = None
        self._overlay = None  # (program, vao, vbo, texture) for the help panel

    # -- thread-safe API ----------------------------------------------------

    def update_media(self, update: MediaUpdate):
        """Enqueue a media change (called from the node thread; ref :652-658)."""
        self.media_queue.put(update)

    def stop(self):
        self.state.quit_request = True

    # -- queue handling (runs on the viewer thread) --------------------------

    def check_for_updates(self) -> bool:
        """Drain the queue; apply the newest update. Returns True if media
        changed (ref :288-336)."""
        latest = None
        while True:
            try:
                latest = self.media_queue.get_nowait()
            except queue.Empty:
                break
        if latest is None:
            return False
        self.current_media = latest
        self.state.stereo_format = latest.stereo_format
        self.state.projection = latest.projection
        self.state.swap_eyes = latest.swap_eyes
        self.state.loop = latest.loop_video
        self.state.screen_size = latest.screen_size
        self.state.screen_distance = latest.screen_distance
        self.background_color = tuple(latest.background_color)
        self._video_frame = 0
        if latest.video_path and latest.audio_enabled:
            self.audio = AudioPlayer(latest.video_path)
        else:
            self.audio = None
        return True

    def tick(self) -> Optional[MediaUpdate]:
        """One iteration of queue/frame bookkeeping (extracted from the render
        loop so it is testable without a headset). Polls immediately on the
        first frame, then every MEDIA_POLL_INTERVAL frames (ref :419-421)."""
        poll = self._frame_counter % MEDIA_POLL_INTERVAL == 0
        self._frame_counter += 1
        changed = None
        if poll and self.check_for_updates():
            changed = self.current_media
        return changed

    # -- the hardware render loop -------------------------------------------

    def run(self):
        """Create the OpenXR session and render until quit (ref :349-646)."""
        if not constants.PYOPENXR_AVAILABLE:
            raise RuntimeError(
                "PyOpenXR/OpenGL/GLFW are not available; install pyopenxr, "
                "PyOpenGL and glfw and connect a headset runtime.")
        import xr

        from .context import GLFWVisibleContextProvider

        self.running = True
        self.ready.set()
        context_provider = None
        try:
            context_provider = GLFWVisibleContextProvider()
            try:  # pyopenxr >= 1.1 GL helper; falls back to plain ContextObject
                from xr.utils.gl import ContextObject
                ctx_kwargs = dict(context_provider=context_provider)
            except ImportError:
                ContextObject = xr.ContextObject
                ctx_kwargs = {}
            with ContextObject(
                    instance_create_info=xr.InstanceCreateInfo(
                        enabled_extension_names=[
                            xr.KHR_OPENGL_ENABLE_EXTENSION_NAME]),
                    **ctx_kwargs) as ctx:
                self._run_frames(ctx, context_provider)
                self._release_gl()
        except Exception as e:
            print(f"[comfystereo-tpu] VR viewer error: {e}")
            import traceback
            traceback.print_exc()
        finally:
            self._teardown(context_provider)

    def _run_frames(self, ctx, context_provider):
        from OpenGL import GL

        from . import rendering

        self._program = rendering.create_stereo_shaders()
        GL.glEnable(GL.GL_DEPTH_TEST)
        self._last_frame_time = time.time()
        for frame_state in ctx.frame_loop():
            if self.state.quit_request:
                break
            if self.tick() is not None:
                self._load_media_gl()
            # Keyboard + control-window overlay (runs in the GLFW context).
            context_provider.poll_keys(self.keyboard)
            self._render_control_window(context_provider)
            # Apply keyboard-driven playback state (pause/seek/restart).
            apply_playback_state(self.state, self.video_capture, self.audio)
            self._sync_audio_pause()
            # Rebuild geometry when projection/size/distance/alignment change.
            key = geometry_key(self.state, self._aspect)
            if key != self._geometry_key:
                self._setup_geometry_gl()
            # Advance video from the audio clock (wall-clock fallback).
            self._advance_video_gl()
            for view_index, view in enumerate(ctx.view_loop(frame_state)):
                self._render_eye(view, view_index)

    # -- GL helpers (each assumes an active GL context) -----------------------

    def _load_media_gl(self):
        from OpenGL import GL

        from .media import load_image_texture, update_texture_from_frame

        media = self.current_media
        if self._texture is not None:
            GL.glDeleteTextures([self._texture])
            self._texture = None
        if self.video_capture is not None:
            self.video_capture.release()
            self.video_capture = None
        if media is None:
            return
        if media.video_path:
            self.video_capture = VideoCapture(media.video_path)
            w, h = self.video_capture.size()
            ok, frame = self.video_capture.read()
            self._texture = GL.glGenTextures(1)
            GL.glBindTexture(GL.GL_TEXTURE_2D, self._texture)
            GL.glTexImage2D(GL.GL_TEXTURE_2D, 0, GL.GL_RGB8, w, h, 0,
                            GL.GL_RGB, GL.GL_UNSIGNED_BYTE, None)
            GL.glTexParameteri(GL.GL_TEXTURE_2D, GL.GL_TEXTURE_MIN_FILTER,
                               GL.GL_LINEAR)
            GL.glTexParameteri(GL.GL_TEXTURE_2D, GL.GL_TEXTURE_MAG_FILTER,
                               GL.GL_LINEAR)
            if ok:
                update_texture_from_frame(self._texture, frame)
            self._aspect = calculate_aspect_ratio(w, h, self.state.stereo_format)
            if self.audio is not None:
                self.audio.play(start=0.0)
            self._last_frame_time = time.time()
        elif media.image_path:
            self._texture, w, h = load_image_texture(media.image_path)
            self._aspect = calculate_aspect_ratio(w, h, self.state.stereo_format)
        self._geometry_key = None  # force a rebuild for the new aspect

    def _setup_geometry_gl(self):
        from OpenGL import GL

        from . import rendering

        if self._vao is not None:
            GL.glDeleteVertexArrays(1, [self._vao])
            GL.glDeleteBuffers(1, [self._vbo])
            GL.glDeleteBuffers(1, [self._ebo])
        verts, idx = build_projection_mesh(self.state, self._aspect)
        self._vao, self._vbo, self._ebo = rendering.setup_vao_vbo(verts, idx)
        self._index_count = int(idx.size)
        self._geometry_key = geometry_key(self.state, self._aspect)

    def _sync_audio_pause(self):
        if self.audio is None:
            self._was_paused = self.state.paused
            return
        if self.state.paused and not self._was_paused:
            self.audio.pause()
        elif self._was_paused and not self.state.paused:
            pos = self.video_capture.current_frame / max(
                self.video_capture.fps, 1e-6) if self.video_capture else 0.0
            self.audio.play(start=pos)
        self._was_paused = self.state.paused

    def _advance_video_gl(self):
        from .media import update_texture_from_frame

        cap = self.video_capture
        if cap is None or self.state.paused or self._texture is None:
            return
        audio_pos = None
        if self.audio is not None and self.audio.available:
            audio_pos = self.audio.get_position()
        now = time.time()
        target, action = video_frame_action(
            audio_pos, now, self._last_frame_time, cap.fps, cap.current_frame)
        if action == "hold":
            return
        if action == "seek":
            cap.seek(target)
        ok, frame = cap.read()
        if not ok:
            if end_of_video_action(self.state.loop) == "restart":
                cap.restart()
                if self.audio is not None:
                    self.audio.seek(0.0)
                ok, frame = cap.read()
            if not ok:
                return
        update_texture_from_frame(self._texture, frame)
        self._last_frame_time = now

    def _render_control_window(self, context_provider):
        """Help overlay in the visible GLFW control window (ref :140-195)."""
        from OpenGL import GL
        import glfw

        window = context_provider.window
        if window is None:
            return
        glfw.make_context_current(window)
        w, h = glfw.get_framebuffer_size(window)
        GL.glViewport(0, 0, w, h)
        GL.glClearColor(0.1, 0.1, 0.1, 1.0)
        GL.glClear(GL.GL_COLOR_BUFFER_BIT)
        if self._overlay is None:
            self._overlay = self._init_overlay_gl()
        if self._overlay is not None:
            program, vao, _, tex = self._overlay
            GL.glDisable(GL.GL_DEPTH_TEST)
            GL.glEnable(GL.GL_BLEND)
            GL.glBlendFunc(GL.GL_SRC_ALPHA, GL.GL_ONE_MINUS_SRC_ALPHA)
            GL.glUseProgram(program)
            GL.glActiveTexture(GL.GL_TEXTURE0)
            GL.glBindTexture(GL.GL_TEXTURE_2D, tex)
            GL.glUniform1i(GL.glGetUniformLocation(program, "u_texture"), 0)
            GL.glBindVertexArray(vao)
            GL.glDrawArrays(GL.GL_TRIANGLE_FAN, 0, 4)
            GL.glBindVertexArray(0)
            GL.glDisable(GL.GL_BLEND)
            GL.glEnable(GL.GL_DEPTH_TEST)
        GL.glFlush()  # single-buffered control window

    def _init_overlay_gl(self):  # pragma: no cover - GL
        import ctypes

        from OpenGL import GL
        import numpy as np

        from . import rendering
        from .controls import create_help_overlay_texture

        try:
            program = rendering.compile_program(
                rendering.OVERLAY_VERTEX_SHADER,
                rendering.OVERLAY_FRAGMENT_SHADER)
            pixels = create_help_overlay_texture()
            tex = GL.glGenTextures(1)
            GL.glBindTexture(GL.GL_TEXTURE_2D, tex)
            GL.glTexImage2D(GL.GL_TEXTURE_2D, 0, GL.GL_RGBA8,
                            pixels.shape[1], pixels.shape[0], 0, GL.GL_RGBA,
                            GL.GL_UNSIGNED_BYTE, pixels)
            GL.glTexParameteri(GL.GL_TEXTURE_2D, GL.GL_TEXTURE_MIN_FILTER,
                               GL.GL_LINEAR)
            GL.glTexParameteri(GL.GL_TEXTURE_2D, GL.GL_TEXTURE_MAG_FILTER,
                               GL.GL_LINEAR)
            # Fullscreen fan: (x, y, u, v); texture rows are top-down.
            quad = np.array([[-1, -1, 0, 1], [1, -1, 1, 1],
                             [1, 1, 1, 0], [-1, 1, 0, 0]], dtype=np.float32)
            vao = GL.glGenVertexArrays(1)
            GL.glBindVertexArray(vao)
            vbo = GL.glGenBuffers(1)
            GL.glBindBuffer(GL.GL_ARRAY_BUFFER, vbo)
            GL.glBufferData(GL.GL_ARRAY_BUFFER, quad.nbytes, quad,
                            GL.GL_STATIC_DRAW)
            GL.glVertexAttribPointer(0, 2, GL.GL_FLOAT, GL.GL_FALSE, 16,
                                     ctypes.c_void_p(0))
            GL.glEnableVertexAttribArray(0)
            GL.glVertexAttribPointer(1, 2, GL.GL_FLOAT, GL.GL_FALSE, 16,
                                     ctypes.c_void_p(8))
            GL.glEnableVertexAttribArray(1)
            GL.glBindVertexArray(0)
            return program, vao, vbo, tex
        except Exception as e:
            print(f"[comfystereo-tpu] help overlay unavailable: {e}")
            return None

    def _render_eye(self, view, eye):
        from OpenGL import GL

        from . import math3d
        from .constants import FORMAT_SHADER_IDS

        GL.glClearColor(*self.background_color, 1.0)
        GL.glClear(GL.GL_COLOR_BUFFER_BIT | GL.GL_DEPTH_BUFFER_BIT)
        if self._texture is None or self._vao is None:
            return  # nothing loaded yet; show background
        mvp = math3d.mvp(math3d.xr_fov_projection(view),
                         math3d.xr_pose_view(view))
        GL.glUseProgram(self._program)
        GL.glUniformMatrix4fv(
            GL.glGetUniformLocation(self._program, "u_mvp"), 1, GL.GL_TRUE,
            mvp)  # row-major numpy -> transpose on upload
        GL.glUniform1i(GL.glGetUniformLocation(self._program, "u_stereo_format"),
                       FORMAT_SHADER_IDS[self.state.stereo_format])
        GL.glUniform1i(GL.glGetUniformLocation(self._program, "u_eye_index"),
                       eye)
        GL.glUniform1i(GL.glGetUniformLocation(self._program, "u_swap_eyes"),
                       int(self.state.swap_eyes))
        GL.glActiveTexture(GL.GL_TEXTURE0)
        GL.glBindTexture(GL.GL_TEXTURE_2D, self._texture)
        GL.glUniform1i(GL.glGetUniformLocation(self._program, "u_texture"), 0)
        GL.glBindVertexArray(self._vao)
        GL.glDrawElements(GL.GL_TRIANGLES, self._index_count,
                          GL.GL_UNSIGNED_INT, None)
        GL.glBindVertexArray(0)

    def _release_gl(self):
        """Delete GL resources while the context is still alive (ref :558-601)."""
        from OpenGL import GL

        try:
            if self._texture is not None:
                GL.glDeleteTextures([self._texture])
            if self._vao is not None:
                GL.glDeleteVertexArrays(1, [self._vao])
                GL.glDeleteBuffers(1, [self._vbo])
                GL.glDeleteBuffers(1, [self._ebo])
            if self._overlay is not None:
                program, vao, vbo, tex = self._overlay
                GL.glDeleteTextures([tex])
                GL.glDeleteVertexArrays(1, [vao])
                GL.glDeleteBuffers(1, [vbo])
                GL.glDeleteProgram(program)
            if self._program is not None:
                GL.glDeleteProgram(self._program)
        except Exception as e:
            print(f"[comfystereo-tpu] GL cleanup warning: {e}")
        self._texture = None
        self._vao = self._vbo = self._ebo = None
        self._overlay = None
        self._program = None

    def _teardown(self, context_provider=None):
        """Full state reset so a new viewer can start cleanly (ref :604-646).
        Order matters: media first, then the GLFW context, then GC so OpenXR
        releases its session before the next instance starts."""
        if self.video_capture is not None:
            try:
                self.video_capture.release()
            except Exception:
                pass
            self.video_capture = None
        if self.audio is not None:
            try:
                self.audio.stop()
            except Exception:
                pass
            self.audio = None
        if context_provider is not None:
            try:
                context_provider.destroy()
            except Exception:
                pass
        gc.collect()
        while not self.media_queue.empty():
            try:
                self.media_queue.get_nowait()
            except Exception:
                break
        self.current_media = None
        self.state = ViewerState()
        self.keyboard = KeyboardHandler(self.state)
        self.running = False
        self.ready.clear()
        self._frame_counter = 0
        self._video_frame = 0
        self._geometry_key = None
        self._was_paused = False
