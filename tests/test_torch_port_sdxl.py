"""SDXL-inpainting in the port: the SD UNet with SDXL's topology (no
attention on the first level, deep transformer stacks, linear projections,
text-time conditioning) against the benchmark's plain float32 reference
(`stereo_bench/reference/sdxl_plain.py`), on the weights and conditioning
that the SDXL driver draws (`stereo_bench/drivers/stereo_diffusion_node_xl.py`),
at the tiny widths of its `TINY_SETTINGS` on the CPU; the published
configuration's keys and shapes on the meta device; the checkpoint path's
config inference; the bundle's latent scale and pooled embeddings; the node
passing the frame's size into the time ids; and Standard mode refusing such
a bundle.

Tolerances:
- the UNet in float32 against the reference: atol = rtol = 1e-4, as the SD
  tests hold the two (the program's norms take E[x^2] - mean^2 and round
  once; the reference uses `F.group_norm` and `F.layer_norm`);
- the node's right eye in float32: relative L2 1e-5 inside the mask, as
  the SD test, and every other compared number 0;
- the UNet in bf16 against the float32 reference: relative L2 under
  `BF16_BOUND` = 0.03. bf16 rounds each operand and activation to 8
  significant bits (a relative error of up to 2^-9), and the errors of the
  tiny UNet's 40-odd rounded layers in sequence add up to 0.0148 on these
  inputs; the bound leaves twice that. Zeroed time ids or pooled
  embeddings move the output by 0.21, and the cut stacks by more than
  five times the bound too.
"""
import dataclasses
import hashlib
import json
from pathlib import Path

import pytest
import torch

from comfystereo_tpu_torch.diffusion import (SUPPORTED_MODEL_TYPES, porting, sd_pipeline,
                                             sd_unet)
from comfystereo_tpu_torch.diffusion.attention import AttentionMode
from comfystereo_tpu_torch.diffusion.models import LATENT_SCALE, SDXL_LATENT_SCALE
from comfystereo_tpu_torch.diffusion.sd_unet import (SD15_INPAINT_UNET_CONFIG,
                                                     SD15_UNET_CONFIG, SD21_UNET_CONFIG,
                                                     SDXL_INPAINT_UNET_CONFIG,
                                                     TINY_SD_UNET_CONFIG, SDUNet, SDUNetConfig)
from comfystereo_tpu_torch.diffusion.sd_vae import SD_VAE_CONFIG, TINY_SD_VAE_CONFIG, SDVAE
from comfystereo_tpu_torch.nodes.stereodiffusion import StereoDiffusionNode
from stereo_bench.drivers import stereo_diffusion_node_xl as driver
from stereo_bench.reference import sdxl_plain

BENCH = Path(__file__).resolve().parent.parent / "stereo_bench"
CONFIG = json.loads((BENCH / "configs" / "sdxl_inpaint_fast.json").read_text())
TRAFFIC = {**json.loads((BENCH / "traffic" / "frame1024_b1.json").read_text()), **driver.TINY}
SETTINGS = {**CONFIG["settings"], **driver.TINY_SETTINGS}
CPU = torch.device("cpu")
SEED = 2 ** 31 + 29
BF16_BOUND = 0.03


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: the suite runs in several worker
    processes on a few cores, where each worker's parallel regions waiting
    on threads the others hold cost far more than one thread's speed."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _config(cls, d):
    return cls(**{k: tuple(v) if isinstance(v, list) else v for k, v in d.items()})


TINY_CFG = _config(SDUNetConfig, SETTINGS["unet"])


def _rel_l2(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


@pytest.fixture(scope="module")
def drawn():
    return driver.weights(SETTINGS, CPU)


@pytest.fixture(scope="module")
def reference_unet(drawn):
    return sdxl_plain.loaded(sdxl_plain.UNet, SETTINGS["unet"], drawn["unet"])


def _program_unet(drawn, dtype=torch.float32):
    return porting.build_sd_model(TINY_CFG, TINY_SD_VAE_CONFIG, dtype=dtype, device=CPU,
                                  unet_state=drawn["unet"], vae_state=drawn["vae"])


@pytest.fixture(scope="module")
def unet_inputs():
    gen = torch.Generator().manual_seed(3)
    lat = torch.randn((2, 9, 32, 32), generator=gen)
    ctx = torch.randn((2, 77, 32), generator=gen)
    pooled = torch.randn((2, driver.pooled_width(SETTINGS["unet"])), generator=gen)
    ids = torch.tensor([[96.0, 128.0, 0.0, 0.0, 128.0, 128.0],
                        [1024.0, 768.0, 0.0, 0.0, 128.0, 128.0]])
    return lat, ctx, pooled, ids


def test_tiny_settings_have_sdxls_topology():
    assert TINY_CFG.text_time and TINY_CFG.use_linear_projection
    assert [TINY_CFG.has_attention(i) for i in range(3)] == [False, True, True]
    assert TINY_CFG.transformer_layers_per_block == (1, 1, 2)
    assert TINY_CFG.in_channels == 9 and TINY_CFG.pooled_dim == 16
    assert _config(type(TINY_SD_VAE_CONFIG), SETTINGS["vae"]) == TINY_SD_VAE_CONFIG


def test_configuration_is_the_published_one():
    s = CONFIG["settings"]
    assert CONFIG["reduced"] == [] and s["dtype"] == "bfloat16"
    assert _config(SDUNetConfig, s["unet"]) == SDXL_INPAINT_UNET_CONFIG
    assert _config(type(SD_VAE_CONFIG), s["vae"]) == SD_VAE_CONFIG
    assert s["sample_size"] == 1024 and s["latent_scale"] == SDXL_LATENT_SCALE == 0.13025
    assert SDXL_INPAINT_UNET_CONFIG.pooled_dim == 1280


@pytest.mark.parametrize("t", [1, 421, 981])
def test_unet_float32_matches_the_reference(drawn, reference_unet, unet_inputs, t):
    lat, ctx, pooled, ids = unet_inputs
    got = _program_unet(drawn).unet_apply(lat, t, ctx, text_embeds=pooled, time_ids=ids)
    want = reference_unet(lat, t, ctx, pooled, ids)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def _bf16_off(drawn, reference_unet, unet_inputs, **change):
    lat, ctx, pooled, ids = unet_inputs
    kw = {"text_embeds": pooled, "time_ids": ids, **change}
    got = _program_unet(drawn, torch.bfloat16).unet_apply(lat, 601, ctx, **kw)
    return _rel_l2(got, reference_unet(lat, 601, ctx, pooled, ids))


def test_unet_bf16_is_within_the_bound(drawn, reference_unet, unet_inputs):
    off = _bf16_off(drawn, reference_unet, unet_inputs)
    assert 0 < off < BF16_BOUND


@pytest.mark.parametrize("what", ["time_ids", "text_embeds"])
def test_zeroed_conditioning_moves_the_output_beyond_the_bound(drawn, reference_unet,
                                                                unet_inputs, what):
    zero = torch.zeros_like(unet_inputs[3 if what == "time_ids" else 2])
    assert _bf16_off(drawn, reference_unet, unet_inputs, **{what: zero}) > 5 * BF16_BOUND


def test_cut_stacks_move_the_output_beyond_the_bound(drawn, reference_unet, unet_inputs,
                                                      monkeypatch):
    driver._stacks_cut(monkeypatch)
    assert _bf16_off(drawn, reference_unet, unet_inputs) > 5 * BF16_BOUND


def test_unet_without_its_conditioning_refuses_the_call(drawn, unet_inputs):
    lat, ctx, pooled, ids = unet_inputs
    unet = _program_unet(drawn).unet
    with pytest.raises(ValueError, match="text_embeds and time_ids"):
        unet(lat, 11, ctx)
    sd = SDUNet(TINY_SD_UNET_CONFIG)
    with pytest.raises(ValueError, match="without text-time"):
        sd(lat[:, :4, :16, :16], 11, torch.zeros((2, 77, 64)), text_embeds=pooled,
           time_ids=ids)


def test_full_width_keys_and_shapes_are_the_references():
    """SDXL_INPAINT_UNET_CONFIG's parameters on the meta device, key for key
    and shape for shape, are the reference's (the diffusers checkpoint's),
    and the driver's full-size draw passes the checkpoint path's check."""
    with torch.device("meta"):
        state = SDUNet(SDXL_INPAINT_UNET_CONFIG).state_dict()
    got = {k: tuple(v.shape) for k, v in state.items()}
    want = {k: tuple(v) for k, v in sdxl_plain.state_keys(sdxl_plain.UNet,
                                                           CONFIG["settings"]["unet"]).items()}
    assert got == want
    assert sum(torch.Size(s).numel() for s in got.values()) == 2_567_478_084
    assert "add_embedding.linear_1.weight" in got
    assert got["down_blocks.1.attentions.0.proj_in.weight"] == (640, 640)
    state = driver.weights(CONFIG["settings"], "meta")["unet"]
    porting.check_port(porting._meta_state(SDUNet, SDXL_INPAINT_UNET_CONFIG),
                       porting.normalize_state_dict(state))
    blocks = [m for m in SDUNet(TINY_CFG).modules()
              if isinstance(m, sd_unet.BasicTransformerBlock)]
    assert len(blocks) == 2 * 1 + 2 * 2 + 2 + 3 * 1 + 3 * 2  # down, mid, up


# The existing configurations' (key, shape) lists, sha256 of their JSON, as
# the module built them before SDXL's fields existed.
STATE_DIGESTS = {
    "SD15_UNET_CONFIG": (SD15_UNET_CONFIG, 686, 859_520_964,
                         "e2aa9572d82bca0384705495146e5f8097dd7c9567003b17fdc836bb785716ec"),
    "SD15_INPAINT_UNET_CONFIG": (SD15_INPAINT_UNET_CONFIG, 686, 859_535_364,
                                 "b1e6ba33234745bf6e01ede9d587c238fb3ce7e77e1b17389e339bfe9f2a8e15"),
    "SD21_UNET_CONFIG": (SD21_UNET_CONFIG, 686, 865_910_724,
                         "80f59b1c3779d08e798e940fd78dd3f74f861f075f3682b1f6828936e6e28128"),
    "TINY_SD_UNET_CONFIG": (TINY_SD_UNET_CONFIG, 208, 803_204,
                            "2bf97cc7c85ced571dde0f7a05023f4f075892becd69a9eec311a125d49d4211"),
}


@pytest.mark.parametrize("name", list(STATE_DIGESTS))
def test_existing_configs_state_dicts_are_unchanged(name):
    cfg, n_keys, n_params, digest = STATE_DIGESTS[name]
    with torch.device("meta"):
        state = SDUNet(cfg).state_dict()
    pairs = [(k, list(v.shape)) for k, v in state.items()]
    assert len(pairs) == n_keys
    assert sum(v.numel() for v in state.values()) == n_params
    assert not any(k.startswith("add_embedding") for k, _ in pairs)
    assert all(len(s) == 4 for k, s in pairs if ".proj_in." in k and k.endswith("weight"))
    assert hashlib.sha256(json.dumps(pairs).encode()).hexdigest() == digest


@pytest.mark.parametrize("cfg", [SDXL_INPAINT_UNET_CONFIG, None], ids=["full", "tiny"])
def test_config_inference_round_trip(cfg):
    """State dict, then inferred config, then an equal config: SDXL's on the
    meta device, and a tiny one of 64-d heads (the width inference assumes)
    with real tensors on the CPU, normalised as a checkpoint is (linear
    projections kept 2-D, `add_embedding` kept)."""
    if cfg is None:
        cfg = dataclasses.replace(TINY_CFG, block_out_channels=(64, 128, 128),
                                  attention_head_dim=(1, 2, 2), norm_num_groups=32,
                                  addition_time_embed_dim=256,
                                  projection_class_embeddings_input_dim=16 + 6 * 256)
        state = SDUNet(cfg).state_dict()
    else:
        with torch.device("meta"):
            state = SDUNet(cfg).state_dict()
    norm = porting.normalize_state_dict(state)
    assert norm.keys() == state.keys()
    assert norm["mid_block.attentions.0.proj_out.weight"].dim() == 2
    assert porting.infer_unet_config(norm) == cfg


def test_sdxl_is_supported():
    assert "SDXL" in SUPPORTED_MODEL_TYPES


def test_bundle_latent_scale_and_pooled_embeddings(drawn):
    xl = _program_unet(drawn)
    assert xl.latent_scale == SDXL_LATENT_SCALE
    assert tuple(xl.pooled_encode("a prompt").shape) == (1, 16)
    sd = porting.build_sd_model(TINY_SD_UNET_CONFIG, TINY_SD_VAE_CONFIG, device=CPU)
    assert sd.latent_scale == LATENT_SCALE and sd.pooled_encode is None
    from comfystereo_tpu_torch.diffusion import inversion
    img = torch.rand((1, 3, 16, 16)) * 2 - 1
    assert torch.equal(inversion.image_to_latent(xl, img), xl.vae_encode(img) * 0.13025)


# The node's tests run in float32 at a 64x64 sample size (a 32x32 latent):
# the float32 program is the reference's arithmetic at any size.
SMALL = {**SETTINGS, "dtype": "float32", "sample_size": 64}


def test_node_fast_float32_is_the_reference():
    frame = driver.inputs({**TRAFFIC, "size": 64}, SEED)[0]
    out = driver.program(SMALL, CPU)(frame)
    numbers = driver.compare(driver.select(out, [0]),
                             driver.reference(SMALL, frame, CPU, [0]))
    assert numbers["right_rel_l2"] < 1e-5
    assert {k: v for k, v in numbers.items() if k != "right_rel_l2"} == {
        "left_max_off": 0.0, "mask_off_share": 0.0, "outside_max_off": 0.0}


def test_node_gives_the_frames_size_to_the_time_ids_and_counts(monkeypatch):
    """A 48x56 frame is resized to the 64x64 sample size; every UNet call
    of its 13 takes the time ids (48, 56, 0, 0, 64, 64) and the pooled
    embeddings of "" and the prompt for the two halves of the guidance,
    and the counter of calls with text-time conditioning moves by 13."""
    bundle = driver._bundle(SMALL, CPU)
    seen = []
    real = bundle.unet_apply

    def spy(lat, t, ctx, **kw):
        seen.append({k: v.clone() for k, v in kw.items()})
        return real(lat, t, ctx, **kw)

    bundle.unet_apply = spy
    gen = torch.Generator().manual_seed(1)
    image, depth = torch.rand((1, 48, 56, 3), generator=gen), torch.rand((1, 48, 56, 3))
    before = (sd_pipeline.UNET_CALLS, sd_pipeline.ADDED_COND_CALLS)
    StereoDiffusionNode().generate_stereo(image, depth, model=bundle, device=CPU,
                                          prompt="a room", num_inference_steps=20)
    assert (sd_pipeline.UNET_CALLS - before[0], sd_pipeline.ADDED_COND_CALLS - before[1]) \
        == (13, 13)
    pooled = torch.cat([driver.conditioning(SETTINGS, "", CPU)[1],
                        driver.conditioning(SETTINGS, "a room", CPU)[1]])
    for kw in seen:
        assert kw["time_ids"].tolist() == [[48.0, 56.0, 0.0, 0.0, 64.0, 64.0]] * 2
        assert torch.equal(kw["text_embeds"], pooled)


def test_sd_bundle_calls_carry_no_conditioning(monkeypatch):
    """An SD bundle's UNet calls take no keyword beyond those they took
    before, and the counter of conditioned calls does not move."""
    bundle = porting.build_sd_model(dataclasses.replace(TINY_SD_UNET_CONFIG, in_channels=9),
                                    TINY_SD_VAE_CONFIG, device=CPU)
    bundle.sample_size = 32
    seen = []
    real = bundle.unet_apply
    bundle.unet_apply = lambda lat, t, ctx, **kw: seen.append(kw) or real(lat, t, ctx, **kw)
    before = sd_pipeline.ADDED_COND_CALLS
    StereoDiffusionNode().generate_stereo(torch.rand((1, 32, 32, 3)), torch.rand((1, 32, 32, 3)),
                                          model=bundle, device=CPU, num_inference_steps=4)
    assert seen and all(kw == {} for kw in seen)
    assert sd_pipeline.ADDED_COND_CALLS == before


def test_graph_key_and_graphable_take_the_conditioning(unet_inputs):
    """A call without text-time conditioning keys as before; one with it
    adds its tensors' shapes, strides and dtypes, so new values of the same
    kind share a key; on the CPU no call is graphable."""
    lat, ctx, pooled, ids = unet_inputs
    mode = AttentionMode()
    plain = sd_unet.graph_key(lat, 601, ctx, mode, False)
    assert len(plain) == 13
    with_cond = sd_unet.graph_key(lat, 601, ctx, mode, False, pooled, ids)
    assert with_cond[:13] == plain and len(with_cond) == 21
    assert sd_unet.graph_key(lat, 5, ctx, mode, False, pooled + 1, ids * 2) == with_cond
    assert sd_unet.graph_key(lat, 5, ctx, mode, False, pooled, ids[:1]) != with_cond
    assert not sd_unet.graphable(lat, 601, ctx, pooled, ids)


def test_standard_mode_with_an_sdxl_bundle_raises(drawn):
    bundle = _program_unet(drawn)
    with pytest.raises(NotImplementedError, match="Fast"):
        sd_pipeline.text2stereo(bundle, torch.zeros((1, 3, 32, 32)), torch.zeros((1, 32, 32)))
    with pytest.raises(NotImplementedError, match="text-time"):
        StereoDiffusionNode().generate_stereo(torch.rand((1, 32, 32, 3)),
                                              torch.rand((1, 32, 32, 3)), model=bundle,
                                              device=CPU, pipeline_mode="Standard (DDIM)")


def test_vae_keys_are_the_sd_vaes():
    with torch.device("meta"):
        got = {k: tuple(v.shape) for k, v in SDVAE(SD_VAE_CONFIG).state_dict().items()}
    want = {k: tuple(v) for k, v in sdxl_plain.state_keys(sdxl_plain.VAE,
                                                           CONFIG["settings"]["vae"]).items()}
    assert got == want
