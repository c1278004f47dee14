"""Media loading and per-eye aspect logic for the viewer.

Reference: native_viewer/media.py:15-180 — image -> sRGB texture, per-eye
aspect ratio (half width for SBS, half height for OU), and a cv2 VideoCapture
wrapper with fps/seek/restart. Texture upload is gated on OpenGL; the aspect
math and the capture wrapper logic are plain Python.
"""
from __future__ import annotations

from typing import Optional, Tuple

from . import constants
from .constants import StereoFormat


def calculate_aspect_ratio(width: int, height: int,
                           stereo_format: StereoFormat) -> float:
    """Per-eye aspect ratio: SBS halves the width, OU halves the height."""
    if stereo_format == StereoFormat.SBS:
        return (width / 2) / height
    if stereo_format == StereoFormat.OU:
        return width / (height / 2)
    return width / height


def load_image_texture(path: str):  # pragma: no cover - needs OpenGL
    """PIL image -> GL_SRGB8 texture; returns (texture_id, w, h)."""
    from OpenGL import GL
    from PIL import Image
    import numpy as np

    img = Image.open(path).convert("RGB")
    data = np.asarray(img, dtype=np.uint8)
    tex = GL.glGenTextures(1)
    GL.glBindTexture(GL.GL_TEXTURE_2D, tex)
    GL.glTexImage2D(GL.GL_TEXTURE_2D, 0, GL.GL_SRGB8, img.width, img.height,
                    0, GL.GL_RGB, GL.GL_UNSIGNED_BYTE, data)
    GL.glTexParameteri(GL.GL_TEXTURE_2D, GL.GL_TEXTURE_MIN_FILTER, GL.GL_LINEAR)
    GL.glTexParameteri(GL.GL_TEXTURE_2D, GL.GL_TEXTURE_MAG_FILTER, GL.GL_LINEAR)
    return tex, img.width, img.height


def update_texture_from_frame(tex, frame):  # pragma: no cover - needs OpenGL
    """Upload a BGR video frame into an existing texture."""
    import cv2
    from OpenGL import GL

    rgb = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
    GL.glBindTexture(GL.GL_TEXTURE_2D, tex)
    GL.glTexSubImage2D(GL.GL_TEXTURE_2D, 0, 0, 0, rgb.shape[1], rgb.shape[0],
                       GL.GL_RGB, GL.GL_UNSIGNED_BYTE, rgb)


class VideoCapture:
    """Thin cv2.VideoCapture wrapper: fps, frame count, seek, restart."""

    def __init__(self, path: str):
        if not constants.CV2_AVAILABLE:
            raise RuntimeError("cv2 is not available; video playback disabled")
        import cv2

        self._cv2 = cv2
        self.path = path
        self.cap = self._cv2.VideoCapture(path)
        self.fps = self.cap.get(self._cv2.CAP_PROP_FPS) or 30.0
        self.frame_count = int(self.cap.get(self._cv2.CAP_PROP_FRAME_COUNT))
        self.current_frame = 0

    def read(self):
        ok, frame = self.cap.read()
        if ok:
            self.current_frame += 1
        return ok, frame

    def seek(self, frame_idx: int):
        self.cap.set(self._cv2.CAP_PROP_POS_FRAMES, max(0, frame_idx))
        self.current_frame = max(0, frame_idx)

    def restart(self):
        self.seek(0)

    def size(self) -> Tuple[int, int]:
        return (int(self.cap.get(self._cv2.CAP_PROP_FRAME_WIDTH)),
                int(self.cap.get(self._cv2.CAP_PROP_FRAME_HEIGHT)))

    def release(self):
        self.cap.release()
