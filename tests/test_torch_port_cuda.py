"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: these need an NVIDIA GPU and nvcc, and skip where CUDA is
absent. On the card run them with `python -m pytest tests/test_torch_port_cuda.py
-m cuda -q`. chip_smoke.py makes the same comparisons at the main path's
full 1080p shapes.
"""
import numpy as np
import pytest
import torch

from comfystereo_tpu_torch import StereoConfig, stereo_pipeline
from comfystereo_tpu_torch.kernels import distance, warp_kernel
from comfystereo_tpu_torch.ops import depth as depth_ops
from comfystereo_tpu_torch.utils import fixtures

pytestmark = pytest.mark.cuda

H, W = 48, 64


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rows(dev, depth, div_px, sep_px, dtype=torch.float32, channels=3):
    img = fixtures.create_test_image(H, W).astype(np.float32) / 255.0
    image = torch.from_numpy(img[..., :channels].copy()).to(dev, dtype)[None]
    nd = depth_ops.normalize_depth(torch.from_numpy(depth).to(dev)[None])
    off = depth_ops.pixel_offsets(nd, div_px, sep_px, 2.0, 0.5, prenormalized=True)
    kw = dict(gradient_threshold=1.5, max_stretch=8, max_disp=10)
    return (off.reshape(H, W).contiguous(), nd.reshape(H, W).contiguous(),
            image.reshape(H, W, channels).contiguous(), kw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("div_px,sep_px", [(3.0, 0.0), (-3.0, 0.0), (5.0, 1.0)])
def test_warp_kernel_matches_plain(dev, div_px, sep_px, channels, dtype):
    depth = fixtures.create_depth_map(H, W).astype(np.float32)
    off, nd, rows, kw = _rows(dev, depth, div_px, sep_px, dtype, channels)
    before = warp_kernel.LAUNCHES
    out_k, gap_k = warp_kernel.warp_rows(off, nd, rows, **kw)
    torch.cuda.synchronize()
    assert warp_kernel.LAUNCHES == before + 1
    out_p, gap_p = warp_kernel.warp_rows_plain(off, nd, rows, **kw)
    assert torch.equal(gap_k, gap_p)
    assert float((out_k.float() - out_p.float()).abs().max()) <= 1e-5


def test_warp_kernel_rejects_other_channel_counts(dev):
    off = torch.zeros(4, W, device=dev)
    with pytest.raises(ValueError):
        warp_kernel.warp_rows(off, off, torch.zeros(4, W, 2, device=dev),
                              gradient_threshold=1.5, max_stretch=8, max_disp=6)


@pytest.mark.parametrize("p", [0.0, 0.02, 0.5])
def test_distance_kernel_matches_plain(dev, p):
    rng = np.random.default_rng(0)
    ml = torch.from_numpy(rng.random((37, 300)) < p).to(dev)
    mr = torch.from_numpy(rng.random((37, 300)) < p / 2).to(dev)
    before = distance.LAUNCHES
    kl, kr = distance.edge_distances(ml, mr)
    torch.cuda.synchronize()
    assert distance.LAUNCHES == before + 1
    pl, pr = distance.edge_distances_plain(ml, mr)
    assert torch.equal(kl, pl) and torch.equal(kr, pr)


def test_pipeline_on_card_matches_cpu(dev):
    imgs, depths = fixtures.batch_fixture(2, H, W)
    cfg = StereoConfig(depth_map_blur=False, modes=("left-right", "top-bottom"))
    gpu = stereo_pipeline(torch.from_numpy(imgs).to(dev),
                          torch.from_numpy(depths).to(dev), cfg)
    cpu = stereo_pipeline(torch.from_numpy(imgs), torch.from_numpy(depths), cfg)
    assert torch.equal(gpu["mask"].cpu(), cpu["mask"])
    for g, c in zip(gpu["stereo"], cpu["stereo"]):
        assert float((g.cpu() - c).abs().max()) <= 1e-5
