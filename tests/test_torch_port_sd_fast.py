"""The Stereo Diffusion node's Fast path against the benchmark's plain
float32 reference (`stereo_bench/reference/sd_plain.py`), on the weights and
conditioning that the benchmark's driver draws
(`stereo_bench/drivers/stereo_diffusion_node.py`), at the tiny widths of
its `TINY_SETTINGS` on the CPU; the driver's full-size draw through the
program's checkpoint path on the meta device; and the Fast path's spans and
counters (`diffusion/sd_pipeline.py`, `nodes/stereodiffusion.py`).

Tolerances, float32 on both sides:
- UNet eps and VAE encode/decode: relative L2 1e-5. The two compute the
  same operations in other forms (the program's norms take E[x^2] - mean^2
  and round once; the reference uses `F.group_norm` and `F.layer_norm`),
  which differ by a few float32 ulps a layer.
- the node's right eye inside the mask: relative L2 1e-5, the same
  differences through 13 PNDM steps and the VAE; every other compared
  number 0, as the warp, mask, prefill and composite are the same float32
  operations.
The bf16 program is held to the cell's own limits
(`stereo_bench/limits/sd15_inpaint_fast.frame512_b1.json`).
"""
import dataclasses
import json
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from comfystereo_tpu_torch.diffusion import porting, schedulers, sd_pipeline
from comfystereo_tpu_torch.diffusion.sd_unet import (SD15_INPAINT_UNET_CONFIG,
                                                     TINY_SD_UNET_CONFIG, SDUNet)
from comfystereo_tpu_torch.diffusion.sd_vae import SD_VAE_CONFIG, TINY_SD_VAE_CONFIG, SDVAE
from comfystereo_tpu_torch.kernels import flash_attention as fa
from comfystereo_tpu_torch.nodes.stereodiffusion import StereoDiffusionNode
from stereo_bench.counts import sd as sd_counts
from stereo_bench.drivers import stereo_diffusion_node as driver
from stereo_bench.reference import sd_plain

BENCH = Path(__file__).resolve().parent.parent / "stereo_bench"
CELL = "sd15_inpaint_fast.frame512_b1"
CONFIG = json.loads((BENCH / "configs" / "sd15_inpaint_fast.json").read_text())
TRAFFIC = {**json.loads((BENCH / "traffic" / "frame512_b1.json").read_text()), **driver.TINY}
LIMITS = json.loads((BENCH / "limits" / f"{CELL}.json").read_text())
SETTINGS = {**CONFIG["settings"], **driver.TINY_SETTINGS}
CPU = torch.device("cpu")
SEED = 2 ** 31 + 77


def _rel_l2(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


@pytest.fixture(scope="module")
def drawn():
    return driver.weights(SETTINGS, CPU)


@pytest.fixture(scope="module")
def reference_models(drawn):
    return (sd_plain.loaded(sd_plain.UNet, SETTINGS["unet"], drawn["unet"]),
            sd_plain.loaded(sd_plain.VAE, SETTINGS["vae"], drawn["vae"]))


@pytest.fixture(scope="module")
def frames():
    return driver.inputs(TRAFFIC, SEED)


def _config(cls, d):
    return cls(**{k: tuple(v) if isinstance(v, list) else v for k, v in d.items()})


def test_tiny_settings_are_the_programs_tiny_configs():
    unet_cfg = _config(type(TINY_SD_UNET_CONFIG), driver.TINY_SETTINGS["unet"])
    vae_cfg = _config(type(TINY_SD_VAE_CONFIG), driver.TINY_SETTINGS["vae"])
    assert unet_cfg == dataclasses.replace(TINY_SD_UNET_CONFIG, in_channels=9)
    assert vae_cfg == TINY_SD_VAE_CONFIG
    assert driver.TINY_SETTINGS["sample_size"] == driver.TINY["size"]


def test_configuration_is_published_and_the_nodes_defaults():
    """The UNet and VAE widths are SD 1.5-inpainting's, as the program's own
    configs state them, and every node argument is the node's default."""
    s = CONFIG["settings"]
    assert CONFIG["reduced"] == [] and "text_conditioning" in CONFIG["assumed"]
    assert _config(type(SD15_INPAINT_UNET_CONFIG), s["unet"]) == SD15_INPAINT_UNET_CONFIG
    assert _config(type(SD_VAE_CONFIG), s["vae"]) == SD_VAE_CONFIG
    types = StereoDiffusionNode.INPUT_TYPES()
    defaults = {k: v[1]["default"] for group in types.values() for k, v in group.items()
                if len(v) > 1 and "default" in v[1]}
    for k in driver.NODE_ARGS + ("seed",):
        assert s[k] == defaults[k], k
    assert s["sample_size"] == 512 and s["dtype"] == "bfloat16"


@pytest.mark.parametrize("which", ["unet", "vae"])
def test_full_size_draw_loads_through_the_checkpoint_path(which):
    """The driver's draw at SD 1.5-inpainting's widths, on the meta device:
    normalised and checked against the program's modules, key for key and
    shape for shape, as `load_sd_from_diffusers_dir` checks a checkpoint."""
    state = driver.weights(CONFIG["settings"], "meta")[which]
    assert all(t.device.type == "meta" and t.dtype == torch.float32 for t in state.values())
    cls, cfg = (SDUNet, SD15_INPAINT_UNET_CONFIG) if which == "unet" else (SDVAE, SD_VAE_CONFIG)
    normalised = porting.normalize_state_dict(state)
    assert normalised.keys() == state.keys()
    porting.check_port(porting._meta_state(cls, cfg), normalised)
    count = sum(t.numel() for t in state.values())
    assert count == (859_535_364 if which == "unet" else 83_653_863)


def test_draw_is_the_same_from_the_same_seed(drawn):
    again = driver.weights(SETTINGS, CPU)
    for key in ("unet", "vae"):
        assert list(again[key]) == list(drawn[key])
        assert all(torch.equal(again[key][k], v) for k, v in drawn[key].items())
    other = driver.weights({**SETTINGS, "weight_seed": SETTINGS["weight_seed"] + 1}, CPU)
    assert not torch.equal(other["unet"]["conv_in.weight"], drawn["unet"]["conv_in.weight"])
    w = drawn["unet"]["down_blocks.0.resnets.0.conv1.weight"]  # fan_in 32 * 9
    assert abs(float(w.std()) * (32 * 9) ** 0.5 - 1.0) < 0.05
    assert float(drawn["unet"]["conv_in.bias"].abs().max()) == 0.0
    assert float(drawn["vae"]["encoder.conv_norm_out.weight"].min()) == 1.0


def test_reference_unet_matches_the_programs(drawn, reference_models):
    unet = porting.build_sd_model(_config(type(TINY_SD_UNET_CONFIG), SETTINGS["unet"]),
                                  TINY_SD_VAE_CONFIG, device=CPU,
                                  unet_state=drawn["unet"], vae_state=drawn["vae"]).unet
    gen = torch.Generator().manual_seed(3)
    lat = torch.randn((2, 9, 16, 16), generator=gen)
    ctx = torch.randn((2, 77, 64), generator=gen)
    for t in (1, 421, 981):
        want = reference_models[0](lat, t, ctx)
        assert _rel_l2(unet(lat, t, ctx), want) < 1e-5


def test_reference_vae_matches_the_programs(drawn, reference_models):
    vae = porting.build_sd_model(_config(type(TINY_SD_UNET_CONFIG), SETTINGS["unet"]),
                                 TINY_SD_VAE_CONFIG, device=CPU,
                                 unet_state=drawn["unet"], vae_state=drawn["vae"]).vae
    ref = reference_models[1]
    gen = torch.Generator().manual_seed(4)
    img = torch.rand((2, 3, 32, 32), generator=gen) * 2 - 1
    z = torch.randn((2, 4, 16, 16), generator=gen)
    assert _rel_l2(vae.encode(img), ref.encode(img)) < 1e-5
    assert _rel_l2(vae.decode(z), ref.decode(z)) < 1e-5


def test_reference_plms_matches_the_programs_scan_step():
    """The reference's published list form of PLMS against the program's
    scan form, over the strength-skipped timesteps, on the same eps."""
    steps, strength = 20, 0.6
    ref = sd_plain.PLMS(steps)
    ts = ref.strength_timesteps(steps, strength)
    sched = schedulers.make_pndm(steps)
    assert ts == [int(t) for t in schedulers.pndm_skip_timesteps(sched, strength)]
    gen = torch.Generator().manual_seed(5)
    x = torch.randn((1, 4, 8, 8), generator=gen)
    a, b = x.clone(), x.clone()
    ets, cur = torch.zeros((4, 1, 4, 8, 8)), torch.zeros_like(x)
    for i, t in enumerate(ts):
        eps = torch.randn((1, 4, 8, 8), generator=gen)
        a = ref.step(eps, t, a)
        b, ets, cur = schedulers.pndm_scan_step(sched, i, t, ets, cur, eps, b)
        assert float((a - b).abs().max()) < 1e-5


def _node(dtype: str):
    return driver.program({**SETTINGS, "dtype": dtype}, CPU)


def _compare(submit, frame):
    out = submit(frame)
    return driver.compare(driver.select(out, [0]),
                          driver.reference(SETTINGS, frame, CPU, [0]))


def test_node_fast_float32_is_the_reference(frames):
    numbers = _compare(_node("float32"), frames[0])
    assert numbers["right_rel_l2"] < 1e-5
    assert {k: v for k, v in numbers.items() if k != "right_rel_l2"} == {
        "left_max_off": 0.0, "mask_off_share": 0.0, "outside_max_off": 0.0}


def test_node_fast_bf16_is_within_the_cells_limits(frames):
    """The cell's program (bf16 UNet and VAE) on two frames, each within
    every limit of the cell."""
    submit = _node("bfloat16")
    for frame in frames[:2]:
        numbers = _compare(submit, frame)
        assert all(numbers[k] <= lim for k, lim in LIMITS["max"].items()), numbers
        assert numbers["right_rel_l2"] > 0  # bf16 differs from float32


def test_control_is_outside_the_limits(frames):
    """The cell's control (the reference with float8 e4m3 operands in every
    linear layer and convolution) reads `right_rel_l2` over its limit, and
    nothing else moves."""
    submit = driver.control(SETTINGS, CONFIG["control"], CPU)
    numbers = _compare(submit, frames[3])
    assert numbers["right_rel_l2"] > LIMITS["max"]["right_rel_l2"]
    assert all(numbers[k] == 0.0 for k in ("left_max_off", "mask_off_share", "outside_max_off"))


def test_flash_launches_as_counted(frames, monkeypatch):
    """The attentions that take the flash route in one node call on the
    CPU are the ones `counts/sd.py` gives for each UNet call."""
    seen = []
    real = fa.flash_attention

    def spy(q, k, v, scale):
        seen.append((q.shape[0], q.shape[1], k.shape[1], q.shape[2]))
        return real(q, k, v, scale)

    monkeypatch.setattr(fa, "flash_attention", spy)
    _node("bfloat16")(frames[1])
    per_call = sd_counts.flash_shapes(SETTINGS, TRAFFIC["size"])
    assert per_call and seen == per_call * sd_counts.unet_calls(SETTINGS)


def _leaves(*names):
    return tuple((n, ()) for n in names)


# One frame through warp_inpaint at the node's defaults: 13 UNet calls.
WARP_INPAINT = ("diffusion.warp_inpaint", (
    *_leaves("diffusion.warp", "diffusion.vae_encode", "diffusion.vae_encode"),
    *_leaves(*("diffusion.unet", "diffusion.scheduler") * 13),
    *_leaves("diffusion.vae_decode", "diffusion.composite")))


def _traced(fn, tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = sorted((e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"),
                   key=lambda e: (e["ts"], -e["dur"]))
    top = []
    stack = [({"ts": -1e30, "dur": float("inf")}, top)]
    for s in spans:
        while not (stack[-1][0]["ts"] <= s["ts"]
                   and s["ts"] + s["dur"] <= stack[-1][0]["ts"] + stack[-1][0]["dur"]):
            stack.pop()
        kids = []
        stack[-1][1].append((s["name"], kids))
        stack.append((s, kids))

    def freeze(nodes):
        return tuple((name, freeze(kids)) for name, kids in nodes)
    return out, freeze(top)


def test_node_call_records_the_span_tree_and_counts(frames, tmp_path):
    """Under a profiler the node call records one span per stage, returns
    what an untraced call returns, and the counters move by one frame, 13
    UNet calls and 26 latent rows."""
    submit = _node("bfloat16")
    plain = submit(frames[2])
    before = (sd_pipeline.FRAMES, sd_pipeline.UNET_CALLS, sd_pipeline.UNET_ROWS)
    traced, tree = _traced(lambda: submit(frames[2]), tmp_path)
    assert tree == (("node.stereo_diffusion", (WARP_INPAINT,)),)
    assert all(torch.equal(a, b) for a, b in zip(traced, plain))
    after = (sd_pipeline.FRAMES, sd_pipeline.UNET_CALLS, sd_pipeline.UNET_ROWS)
    assert [a - b for a, b in zip(after, before)] == [1, 13, 26]
    assert sd_counts.unet_calls(SETTINGS) == 13
