"""Port's video loop: convert_video on the committed FFV1 goldens, and the
device chunk program against the JAX package's.

The goldens were written by the JAX package's loop; the port's loop on the
CPU must land within 1 LSB of them on at most 5% of pixels, the bound of
tests/test_video_fixture.py for a loop against a differently fused run."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfystereo_tpu.config import StereoConfig as JaxConfig
from comfystereo_tpu.utils import fixtures
from comfystereo_tpu.utils import video as jvideo
from comfystereo_tpu_torch import config_from_fields
from comfystereo_tpu_torch.utils import video as tvideo
from tests.test_video_fixture import (FRAMES_PATH, N_FRAMES, H, W, _decode_all,
                                      _write_fixture_videos)

cv2 = pytest.importorskip("cv2")


def _cfg():
    return JaxConfig(modes=("left-right",), fill_technique="gpu_warp",
                     batch_size=4)


def _bound(got, want):
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1, f"{diff.max()} LSB"
    assert (diff > 0).mean() <= 0.05


def test_convert_video_matches_goldens(tmp_path):
    src, dep = _write_fixture_videos(str(tmp_path))
    out = os.path.join(str(tmp_path), "out.avi")
    total = tvideo.convert_video(src, dep, out, config_from_fields(_cfg()),
                                 progress=False, device="cpu")
    assert total == N_FRAMES
    frames = _decode_all(out)
    assert frames.shape == (N_FRAMES, H, 2 * W, 3)
    _bound(frames, np.load(FRAMES_PATH)["frames"])


def test_convert_video_short_last_chunk(tmp_path):
    """8 frames in chunks of 3: the last chunk is zero-padded, and only its
    real frames are written."""
    src, dep = _write_fixture_videos(str(tmp_path))
    out = os.path.join(str(tmp_path), "out3.avi")
    cfg = config_from_fields(dict(modes=("left-right",), batch_size=3))
    assert tvideo.convert_video(src, dep, out, cfg, progress=False,
                                device="cpu") == N_FRAMES
    _bound(_decode_all(out), np.load(FRAMES_PATH)["frames"])


def test_device_chunk_matches_jax():
    img = fixtures.create_test_image(H, W)
    dm = np.stack([fixtures.create_depth_map(H, W)] * 3, -1)
    bgr = np.stack([np.roll(img, 5 * i, axis=1)[..., ::-1] for i in range(4)])
    dep = np.stack([np.roll(dm, 5 * i, axis=1) for i in range(4)])
    bgr, dep = np.ascontiguousarray(bgr), np.ascontiguousarray(dep)
    want = np.asarray(jvideo._device_chunk_fn()(jnp.asarray(bgr), jnp.asarray(dep),
                                                _cfg()))
    got = tvideo.device_chunk(bgr, torch.from_numpy(dep),
                              config_from_fields(_cfg()), device="cpu")
    assert got.dtype == torch.uint8 and got.shape == (4, H, 2 * W, 3)
    _bound(got.numpy(), want)


def test_entry_points_default_device_needs_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is valid")
    frames = np.zeros((1, H, W, 3), np.uint8)
    with pytest.raises(RuntimeError, match="CUDA"):
        tvideo.device_chunk(frames, frames, config_from_fields(_cfg()))
    with pytest.raises(RuntimeError, match="CUDA"):
        tvideo.convert_video("missing.avi", "missing.avi",
                             str(tmp_path / "out.avi"), progress=False)


def test_convert_video_device_error_does_not_hang(tmp_path, monkeypatch):
    """A chunk that fails on the device (here a stereo_pipeline that raises)
    surfaces its error; the decoder thread, blocked on a full queue, is
    released."""
    import threading

    class ChunkFailed(RuntimeError):
        pass

    def failing_pipeline(*args, **kwargs):
        raise ChunkFailed("device chunk failed")

    monkeypatch.setattr(tvideo, "stereo_pipeline", failing_pipeline)
    src, dep = _write_fixture_videos(str(tmp_path))
    cfg = config_from_fields(dict(batch_size=1))
    caught = []

    def run():
        try:
            tvideo.convert_video(src, dep, str(tmp_path / "bad.avi"), cfg,
                                 progress=False, device="cpu")
        except Exception as exc:  # recorded for the assertion below
            caught.append(exc)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive()
    assert len(caught) == 1 and isinstance(caught[0], ChunkFailed)
