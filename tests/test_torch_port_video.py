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


def _fixture_chunk(n):
    """n fixture frames as BGR uint8, each shifted sideways, and the depth
    map as BGR uint8, shifted alike."""
    img = fixtures.create_test_image(H, W)
    dm = np.stack([fixtures.create_depth_map(H, W)] * 3, -1)
    bgr = np.stack([np.roll(img, 5 * i, axis=1)[..., ::-1] for i in range(n)])
    dep = np.stack([np.roll(dm, 5 * i, axis=1) for i in range(n)])
    return np.ascontiguousarray(bgr), np.ascontiguousarray(dep)


def _group_frames(monkeypatch, frames):
    """`device_chunk` runs in groups of at most `frames` frames."""
    monkeypatch.setattr(tvideo, "_GROUP_BYTES", frames * H * W * 3)


@pytest.mark.parametrize("frames,groups", [(2, 3), (3, 2)])
def test_grouped_device_chunk_matches_one_group_and_jax(frames, groups, monkeypatch):
    """A chunk of 5 frames in groups (the last one short) is the one-group
    run's result bit for bit, and the JAX package's chunk program's within
    the bound of the one-group run."""
    bgr, dep = _fixture_chunk(5)
    cfg = config_from_fields(_cfg())
    whole = tvideo.device_chunk(bgr, dep, cfg, device="cpu")
    _group_frames(monkeypatch, frames)
    assert len(tvideo._groups(5, bgr.nbytes)) == groups
    got = tvideo.device_chunk(bgr, torch.from_numpy(dep), cfg, device="cpu")
    assert got.dtype == torch.uint8 and got.shape == (5, H, 2 * W, 3)
    assert torch.equal(got, whole)
    want = np.asarray(jvideo._device_chunk_fn()(jnp.asarray(bgr), jnp.asarray(dep), _cfg()))
    _bound(got.numpy(), want)


@pytest.mark.parametrize("fill", ["gpu_warp", "polylines_sharp"])
def test_grouped_device_chunk_with_groups_of_other_depth_ranges(fill, monkeypatch):
    """The pipeline tests the depth's range over what it is given (0-1 depth
    is scaled to 0-255): a chunk whose first group's depth is all black and
    whose second's is all white equals its one-group run, since the
    chunk's grey depth is at most 0.9999 in every group."""
    bgr, _ = _fixture_chunk(4)
    dep = np.zeros_like(bgr)
    dep[2:] = 255
    cfg = config_from_fields(dict(modes=("left-right",), fill_technique=fill, batch_size=4))
    whole = tvideo.device_chunk(bgr, dep, cfg, device="cpu")
    _group_frames(monkeypatch, 2)
    assert tvideo._groups(4, bgr.nbytes) == [(0, 2), (2, 4)]
    assert torch.equal(tvideo.device_chunk(bgr, dep, cfg, device="cpu"), whole)


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
