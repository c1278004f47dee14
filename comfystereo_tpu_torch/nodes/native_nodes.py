"""Native VR viewer nodes (OUTPUT_NODE side-effect sinks).

Contract parity with the reference (native_nodes.py) and the JAX package's
nodes: NativeStereoImageViewer (:21-173, saves a content-hashed PNG and
launches/updates the viewer, passthrough output), NativeStereoVideoViewer
(:237-359, path-based with loop control), and NativeVRStatus (:176-234,
diagnostics, which also reports the CUDA device). Images come in as torch
tensors on any device (or numpy arrays); the image node copies one frame to
the host for the PNG and returns its input itself.

The viewer's optional dependencies are probed when a node runs, not when
this module is imported (`viewer/constants.py`).
"""
from __future__ import annotations

import hashlib
import os
import tempfile

import numpy as np

from ..viewer import constants
from ..viewer import (
    MediaUpdate,
    Projection,
    StereoFormat,
    check_openxr_available,
    launch_native_viewer,
)

_FORMATS = {
    "side_by_side": StereoFormat.SBS,
    "over_under": StereoFormat.OU,
    "mono": StereoFormat.MONO,
}
_PROJECTIONS = {
    "flat": Projection.FLAT,
    "curved": Projection.CURVED,
    "sphere360": Projection.SPHERE_360,
    "dome180": Projection.DOME_180,
}
# Reference native_nodes.py:142-149 background-color name -> RGB map.
_BG_COLORS = {
    "Black": (0.0, 0.0, 0.0),
    "Dark Gray": (0.15, 0.15, 0.15),
    "Gray": (0.5, 0.5, 0.5),
    "White": (1.0, 1.0, 1.0),
}


def _temp_dir() -> str:
    try:  # ComfyUI temp dir when hosted
        import folder_paths  # type: ignore

        return folder_paths.get_temp_directory()
    except Exception:
        d = os.path.join(tempfile.gettempdir(), "comfystereo_tpu")
        os.makedirs(d, exist_ok=True)
        return d


def first_frame(image) -> np.ndarray:
    """The first [H, W, 3] frame of a [B, H, W, 3] or [H, W, 3] image (a
    torch tensor on any device, in any float dtype, or a numpy array) as a
    float32 host array; only that frame leaves the device."""
    if image.ndim == 4:
        image = image[0]
    if hasattr(image, "detach"):
        image = image.detach().float().cpu().numpy()
    return np.asarray(image, dtype=np.float32)


def save_hashed_png(image01: np.ndarray) -> str:
    """Save [H,W,3] float 0-1 as a PNG keyed by the md5 of its pixels
    (reference :107-112) so repeated identical frames reuse the file."""
    from PIL import Image

    arr = np.clip(image01 * 255.0, 0, 255).astype(np.uint8)
    key = hashlib.md5(arr.tobytes()).hexdigest()
    path = os.path.join(_temp_dir(), f"stereo_{key}.png")
    if not os.path.exists(path):
        Image.fromarray(arr).save(path)
    return path


def cuda_status() -> str:
    """One line on the CUDA device the port runs on: its name and the
    caching allocator's bytes in use against the card's total, or why there
    is none."""
    import torch

    if not torch.cuda.is_available():
        return "CUDA device:  MISSING (the port's entry points need device='cpu')"
    i = torch.cuda.current_device()
    props = torch.cuda.get_device_properties(i)
    used = torch.cuda.memory_allocated(i) / 2 ** 30
    return (f"CUDA device:  cuda:{i} {torch.cuda.get_device_name(i)}, "
            f"{used:.2f} of {props.total_memory / 2 ** 30:.2f} GiB allocated, "
            f"{torch.cuda.device_count()} device(s)")


class NativeStereoImageViewer:
    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "image": ("IMAGE",),
                "stereo_format": (list(_FORMATS.keys()),),
                "projection": (list(_PROJECTIONS.keys()),),
                "screen_size": ("FLOAT", {"default": 3.0, "min": 1.0,
                                          "max": 10.0, "step": 0.5}),
                "screen_distance": ("FLOAT", {"default": 3.0, "min": 1.0,
                                              "max": 10.0, "step": 0.5}),
                "swap_eyes": ("BOOLEAN", {"default": False}),
            },
            "optional": {
                "background_color": (list(_BG_COLORS.keys()),),
            },
        }

    RETURN_TYPES = ("IMAGE",)
    RETURN_NAMES = ("image",)
    FUNCTION = "view_stereo_native"
    OUTPUT_NODE = True
    CATEGORY = "stereo/vr"

    def view_stereo_native(self, image, stereo_format="side_by_side",
                           projection="flat", screen_size=3.0,
                           screen_distance=3.0, swap_eyes=False,
                           background_color="Black"):
        ok, msg = check_openxr_available()
        if ok:
            path = save_hashed_png(first_frame(image))
            launch_native_viewer(MediaUpdate(
                image_path=path,
                stereo_format=_FORMATS[stereo_format],
                projection=_PROJECTIONS[projection],
                swap_eyes=bool(swap_eyes),
                screen_size=float(screen_size),
                screen_distance=float(screen_distance),
                background_color=_BG_COLORS.get(background_color,
                                                (0.0, 0.0, 0.0))))
        else:
            print(f"[comfystereo-tpu] VR viewer unavailable: {msg}")
        return (image,)


class NativeStereoVideoViewer:
    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "video_path": ("STRING", {"default": ""}),
                "stereo_format": (list(_FORMATS.keys()),),
                "projection": (list(_PROJECTIONS.keys()),),
                "screen_size": ("FLOAT", {"default": 3.0, "min": 1.0,
                                          "max": 10.0, "step": 0.5}),
                "screen_distance": ("FLOAT", {"default": 3.0, "min": 1.0,
                                              "max": 10.0, "step": 0.5}),
                "loop_video": ("BOOLEAN", {"default": True}),
                "audio_enabled": ("BOOLEAN", {"default": True}),
                "swap_eyes": ("BOOLEAN", {"default": False}),
            },
            "optional": {
                "background_color": (list(_BG_COLORS.keys()),),
            },
        }

    RETURN_TYPES = ("STRING",)
    RETURN_NAMES = ("video_path",)
    FUNCTION = "view_video_native"
    OUTPUT_NODE = True
    CATEGORY = "stereo/vr"

    def view_video_native(self, video_path, stereo_format="side_by_side",
                          projection="flat", screen_size=3.0,
                          screen_distance=3.0, loop_video=True,
                          audio_enabled=True, swap_eyes=False,
                          background_color="Black"):
        ok, msg = check_openxr_available()
        if ok and video_path and os.path.exists(video_path):
            launch_native_viewer(MediaUpdate(
                video_path=video_path,
                stereo_format=_FORMATS[stereo_format],
                projection=_PROJECTIONS[projection],
                swap_eyes=bool(swap_eyes), loop_video=bool(loop_video),
                audio_enabled=bool(audio_enabled),
                screen_size=float(screen_size),
                screen_distance=float(screen_distance),
                background_color=_BG_COLORS.get(background_color,
                                                (0.0, 0.0, 0.0))))
        elif not ok:
            print(f"[comfystereo-tpu] VR viewer unavailable: {msg}")
        return (video_path,)


class NativeVRStatus:
    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {}}

    RETURN_TYPES = ("STRING",)
    RETURN_NAMES = ("status",)
    FUNCTION = "get_status"
    CATEGORY = "stereo/vr"

    def get_status(self):
        from ..viewer.audio import ffmpeg_available

        ok, msg = check_openxr_available()
        lines = [
            f"OpenXR stack:  {'available' if constants.PYOPENXR_AVAILABLE else 'MISSING'}",
            f"OpenCV video:  {'available' if constants.CV2_AVAILABLE else 'MISSING'}",
            f"pygame audio:  {'available' if constants.PYGAME_AVAILABLE else 'MISSING'}",
            f"ffmpeg/ffprobe: {'available' if ffmpeg_available() else 'MISSING'}",
            f"Viewer launchable: {ok}",
            msg,
            cuda_status(),
        ]
        status = "\n".join(lines)
        print(status)
        return (status,)


NODE_CLASS_MAPPINGS = {
    "NativeStereoImageViewer": NativeStereoImageViewer,
    "NativeStereoVideoViewer": NativeStereoVideoViewer,
    "NativeVRStatus": NativeVRStatus,
}
NODE_DISPLAY_NAME_MAPPINGS = {
    "NativeStereoImageViewer": "Native VR Image Viewer",
    "NativeStereoVideoViewer": "Native VR Video Viewer",
    "NativeVRStatus": "VR Status",
}
