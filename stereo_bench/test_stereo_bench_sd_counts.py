"""`counts/sd.py` against `torch.utils.flop_counter.FlopCounterMode` on the
plain reference at the SD driver's tiny widths on the CPU: a UNet row, an
encode, a decode and a whole Fast frame count what the counter counts; at
SD 1.5-inpainting's widths the flash launches are `chip_smoke.py`'s
(10 a UNet call, at [16, 4096, 4096, 40] and [16, 1024, 1024, 80])."""
from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from stereo_bench.counts import peaks, sd
from stereo_bench.drivers import stereo_diffusion_node as driver
from stereo_bench.reference import sd_plain

HERE = Path(__file__).resolve().parent
FULL = json.loads((HERE / "configs" / "sd15_inpaint_fast.json").read_text())["settings"]
TINY = {**FULL, **driver.TINY_SETTINGS}
SIZE = driver.TINY["size"]


def _counted(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


@pytest.fixture(scope="module")
def models():
    drawn = driver.weights(TINY, "cpu")
    return (sd_plain.loaded(sd_plain.UNet, TINY["unet"], drawn["unet"]),
            sd_plain.loaded(sd_plain.VAE, TINY["vae"], drawn["vae"]))


@pytest.mark.parametrize("rows", [1, 2])
def test_unet_rows(models, rows):
    lat = sd.latent_size(TINY["vae"], SIZE)
    x = torch.zeros((rows, 9, lat, lat))
    ctx = torch.zeros((rows, 77, TINY["unet"]["cross_attention_dim"]))
    assert _counted(lambda: models[0](x, 500, ctx)) == rows * sd.unet(TINY["unet"], lat)


def test_vae_encode_and_decode(models):
    vae = models[1]
    lat = sd.latent_size(TINY["vae"], SIZE)
    img, z = torch.zeros((1, 3, SIZE, SIZE)), torch.zeros((1, 4, lat, lat))
    assert _counted(lambda: vae.encode(img)) == sd.vae_encode(TINY["vae"], SIZE)
    assert _counted(lambda: vae.decode(z)) == sd.vae_decode(TINY["vae"], SIZE)


def test_fast_frame(models):
    traffic = {"size": SIZE, "distinct": 1}
    image, depth, k = driver.inputs(traffic, 2 ** 31 + 9)[0]
    got = _counted(lambda: sd_plain.fast_path(
        *models, lambda text: driver.conditioning(TINY, text, "cpu"), image, depth, TINY, 5))
    assert got == sd.fast_frame(TINY, SIZE)
    assert sd.unet_calls(TINY) == 13


def test_full_width_flash_launches_and_frame():
    shapes = sd.flash_shapes(FULL, 512)
    assert shapes == [(16, 4096, 4096, 40)] * 5 + [(16, 1024, 1024, 80)] * 5
    nbytes, ops, exps = sd.flash(*shapes[0])
    assert (nbytes, ops, exps) == (2.0 * 16 * 40 * 4 * 4096, 4.0 * 16 * 4096 ** 2 * 40,
                                   16.0 * 4096 ** 2)
    assert peaks.tensor_floor_s(nbytes, ops, exps) == exps / peaks.EXP_PER_S
    # About 0.8 TFLOP a UNet row at a 64x64 latent; 26 rows, two encodes
    # and a decode at 512x512 make about 26 TFLOP a frame.
    assert 0.7e12 < sd.unet(FULL["unet"], 64) < 0.9e12
    assert 24e12 < sd.fast_frame(FULL, 512) < 28e12
