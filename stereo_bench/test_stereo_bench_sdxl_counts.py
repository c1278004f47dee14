"""`counts/sdxl.py` against `torch.utils.flop_counter.FlopCounterMode` on the
plain SDXL reference at the SDXL driver's tiny widths on the CPU: a UNet
row and a whole Fast frame count what the counter counts; the flash
launches that one node call makes on the CPU (the program's bf16 route)
are `flash_shapes`' for each of its UNet calls; and at SDXL-inpainting's
widths a UNet call makes 70 launches, 10 at [20, 4096, 4096, 64] and 60 at
[40, 1024, 1024, 64], with a floor of about 1.5 ms."""
from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from stereo_bench.counts import peaks, sd, sdxl
from stereo_bench.drivers import stereo_diffusion_node_xl as driver
from stereo_bench.reference import sdxl_plain

HERE = Path(__file__).resolve().parent
FULL = json.loads((HERE / "configs" / "sdxl_inpaint_fast.json").read_text())["settings"]
TINY = {**FULL, **driver.TINY_SETTINGS}
SIZE = driver.TINY["size"]


def _counted(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


@pytest.fixture(scope="module")
def models():
    drawn = driver.weights(TINY, "cpu")
    return (sdxl_plain.loaded(sdxl_plain.UNet, TINY["unet"], drawn["unet"]),
            sdxl_plain.loaded(sdxl_plain.VAE, TINY["vae"], drawn["vae"]))


@pytest.mark.parametrize("rows", [1, 2])
def test_unet_rows(models, rows):
    lat = sd.latent_size(TINY["vae"], SIZE)
    x = torch.zeros((rows, 9, lat, lat))
    ctx = torch.zeros((rows, 77, TINY["unet"]["cross_attention_dim"]))
    pooled = torch.zeros((rows, driver.pooled_width(TINY["unet"])))
    ids = torch.zeros((rows, 6))
    assert _counted(lambda: models[0](x, 500, ctx, pooled, ids)) == \
        rows * sdxl.unet(TINY["unet"], lat)


def test_fast_frame(models):
    traffic = {"size": SIZE, "distinct": 1}
    image, depth, k = driver.inputs(traffic, 2 ** 31 + 9)[0]
    got = _counted(lambda: sdxl_plain.fast_path(
        *models, lambda text: driver.conditioning(TINY, text, "cpu"), image, depth, TINY, 5))
    assert got == sdxl.fast_frame(TINY, SIZE)


def test_flash_launches_as_counted(monkeypatch):
    """The attentions that take the flash route in one node call of the
    program on the CPU (bf16) are the ones `flash_shapes` gives for each of
    its 13 UNet calls: at the tiny size, the level of 1,024 tokens."""
    from comfystereo_tpu_torch.kernels import flash_attention as fa
    seen = []
    real = fa.flash_attention

    def spy(q, k, v, scale):
        seen.append((q.shape[0], q.shape[1], k.shape[1], q.shape[2]))
        return real(q, k, v, scale)

    monkeypatch.setattr(fa, "flash_attention", spy)
    frame = driver.inputs({"size": SIZE, "distinct": 1}, 2 ** 31 + 3)[0]
    driver.program(TINY, torch.device("cpu"))(frame)
    per_call = sdxl.flash_shapes(TINY, SIZE)
    assert per_call == [(8, 1024, 1024, 16)] * (2 + 3)
    assert seen == per_call * sd.unet_calls(TINY)


def test_full_width_flash_launches_and_frame():
    shapes = sdxl.flash_shapes(FULL, 1024)
    assert sorted(set(shapes)) == [(20, 4096, 4096, 64), (40, 1024, 1024, 64)]
    assert shapes.count((20, 4096, 4096, 64)) == 10 and shapes.count((40, 1024, 1024, 64)) == 60
    floor = sum(peaks.tensor_floor_s(*sd.flash(*s)) for s in shapes)
    assert 1.4e-3 < floor < 1.6e-3
    # About 6.8 TFLOP a UNet row at a 128x128 latent; 26 rows, two encodes
    # and a decode at 1024x1024 make about 196 TFLOP a frame.
    assert 6.7e12 < sdxl.unet(FULL["unet"], 128) < 6.8e12
    assert 190e12 < sdxl.fast_frame(FULL, 1024) < 200e12
