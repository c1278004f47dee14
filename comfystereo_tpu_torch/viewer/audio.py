"""Audio extraction and playback for VR video viewing.

Reference: native_viewer/audio.py:14-257 — ffprobe codec detection, ffmpeg
extraction with a codec-copy fast path for natively playable codecs (else
re-encode to OGG Vorbis q6), pygame.mixer playback, and a position clock that
drives A/V sync (`get_position()`), with seeking implemented as
play(start=...) plus an offset.

Command construction and the sync clock are testable without audio hardware;
actual playback is gated on pygame + ffmpeg presence.
"""
from __future__ import annotations

import os
import shutil
import subprocess
import tempfile
import time
from typing import Optional

from . import constants

# Codecs pygame.mixer can play from a container directly after codec-copy.
COPYABLE_CODECS = {"mp3", "vorbis", "opus", "flac",
                   "pcm_s16le", "pcm_s24le", "pcm_u8"}
_EXT_FOR_CODEC = {"mp3": ".mp3", "vorbis": ".ogg", "opus": ".opus",
                  "flac": ".flac"}


def ffmpeg_available() -> bool:
    return shutil.which("ffmpeg") is not None and shutil.which("ffprobe") is not None


def detect_audio_codec(video_path: str) -> Optional[str]:
    """First audio stream's codec name via ffprobe, or None."""
    if not ffmpeg_available():
        return None
    try:
        out = subprocess.run(
            ["ffprobe", "-v", "error", "-select_streams", "a:0",
             "-show_entries", "stream=codec_name", "-of",
             "default=noprint_wrappers=1:nokey=1", video_path],
            capture_output=True, text=True, timeout=15)
        codec = out.stdout.strip()
        return codec or None
    except Exception:
        return None


def extraction_command(video_path: str, codec: Optional[str],
                       out_dir: str) -> tuple:
    """(argv, output_path): codec-copy when directly playable, else OGG q6."""
    if codec in COPYABLE_CODECS:
        ext = _EXT_FOR_CODEC.get(codec, ".wav")
        out = os.path.join(out_dir, "audio_copy" + ext)
        argv = ["ffmpeg", "-y", "-i", video_path, "-vn", "-acodec", "copy", out]
    else:
        out = os.path.join(out_dir, "audio.ogg")
        argv = ["ffmpeg", "-y", "-i", video_path, "-vn", "-acodec",
                "libvorbis", "-q:a", "6", out]
    return argv, out


class AudioPlayer:
    """Extract a video's audio track and play it; get_position() is the
    master clock for video frame scheduling."""

    def __init__(self, video_path: str):
        self.video_path = video_path
        self.audio_path: Optional[str] = None
        self._tmpdir: Optional[str] = None
        self._start_offset = 0.0
        self._playing = False
        self.available = constants.PYGAME_AVAILABLE and ffmpeg_available()

    def prepare(self) -> bool:
        if not self.available:
            return False
        codec = detect_audio_codec(self.video_path)
        if codec is None:
            return False
        self._tmpdir = tempfile.mkdtemp(prefix="cstpu_audio_")
        argv, out = extraction_command(self.video_path, codec, self._tmpdir)
        try:
            subprocess.run(argv, capture_output=True, timeout=600, check=True)
        except Exception:
            return False
        self.audio_path = out
        return True

    def play(self, start: float = 0.0):  # pragma: no cover - audio hardware
        import pygame

        if self.audio_path is None and not self.prepare():
            return
        if not pygame.mixer.get_init():
            pygame.mixer.init()
        pygame.mixer.music.load(self.audio_path)
        pygame.mixer.music.play(start=start)
        self._start_offset = start
        self._playing = True

    def get_position(self) -> float:
        """Seconds since media start (playback clock + seek offset)."""
        if not self._playing:  # silent clock fallback
            return 0.0
        import pygame  # pragma: no cover

        pos_ms = pygame.mixer.music.get_pos()  # pragma: no cover
        return self._start_offset + max(pos_ms, 0) / 1000.0  # pragma: no cover

    def seek(self, seconds: float):  # pragma: no cover
        self.play(start=seconds)

    def pause(self):  # pragma: no cover
        import pygame

        pygame.mixer.music.pause()
        self._playing = False

    def stop(self):  # pragma: no cover
        import pygame

        if pygame.mixer.get_init():
            pygame.mixer.music.stop()
        self._playing = False
