"""The UNet's CUDA-graph runner (`diffusion/sd_unet.py:GraphedUNet`, the
`unet_apply` of `porting.build_sd_model`'s bundles) where no card is: on the
CPU every call runs the forward eagerly, as before the runner, and no
counter moves; the graph key separates what a call's launches depend on;
the cache of graphs keeps at most `MAX_GRAPHS`, dropping the least recently
used (with the capture replaced by a stand-in); and the forward's pieces
made capturable (the timestep frequencies held on the device, the group
norm's per-channel statistics) give the bits they gave before.

The graphed path itself runs on the card: `tests/test_torch_port_cuda.py`
holds its replays bit-equal to the eager forward.
"""
import dataclasses

import pytest
import torch

from comfystereo_tpu_torch.diffusion import TINY_SD_UNET_CONFIG, TINY_SD_VAE_CONFIG, sd_unet
from comfystereo_tpu_torch.diffusion.attention import AttentionMode
from comfystereo_tpu_torch.diffusion.porting import build_sd_model
from comfystereo_tpu_torch.kernels import flash_attention as fa

STEREO = AttentionMode(stereo=True, direction="uni", use_cfg=True)


def _counters():
    return sd_unet.UNET_GRAPH_CAPTURES, sd_unet.UNET_GRAPH_CALLS


def _inputs(batch=4, channels=4, size=16, ctx_dim=64, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn((batch, channels, size, size), generator=gen),
            torch.randn((batch, 77, ctx_dim), generator=gen))


@pytest.fixture(scope="module")
def bundles():
    return {dt: build_sd_model(TINY_SD_UNET_CONFIG, TINY_SD_VAE_CONFIG, dtype=dt, seed=0,
                               device="cpu") for dt in (torch.float32, torch.bfloat16)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode,active", [(None, False), (STEREO, False), (STEREO, True)])
def test_cpu_calls_run_eagerly_and_capture_nothing(bundles, dtype, mode, active):
    """On the CPU `unet_apply` is the eager forward on the inputs cast to
    the bundle's dtype, in float32, as the bundle's apply was before the
    runner; it keeps no graph and moves neither counter."""
    m = bundles[dtype]
    lat, ctx = _inputs()
    before = _counters()
    out = m.unet_apply(lat, 601, ctx, mode=mode, stereo_active=active)
    want = m.unet(lat.to(dtype), 601, ctx.to(dtype), mode=mode or AttentionMode(),
                  stereo_active=active).float()
    assert out.dtype == torch.float32
    assert torch.equal(out, want)
    assert _counters() == before
    assert not m.unet_apply.graphs
    assert not sd_unet.graphable(lat, 601, ctx)


def test_cpu_call_with_a_context_that_requires_grad_keeps_its_gradient(bundles):
    m = bundles[torch.float32]
    lat, ctx = _inputs(batch=2)
    ctx.requires_grad_(True)
    with torch.enable_grad():
        m.unet_apply(lat, 11, ctx).square().mean().backward()
    assert ctx.grad is not None and bool(torch.isfinite(ctx.grad).all())
    assert float(ctx.grad.abs().max()) > 0


def _key(lat, t, ctx, mode=None, active=False):
    return sd_unet.graph_key(lat, t, ctx, mode or AttentionMode(), active)


def test_graph_key_is_the_same_for_new_values_of_the_same_kind():
    lat, ctx = _inputs(seed=0)
    lat2, ctx2 = _inputs(seed=1)
    assert _key(lat, 601, ctx) == _key(lat2, 1, ctx2)
    assert _key(lat, torch.tensor(601), ctx) == _key(lat, 3, ctx)
    assert hash(_key(lat, 601, ctx, STEREO, True)) == hash(_key(lat2, 21, ctx2, STEREO, True))


@pytest.mark.parametrize("what", ["latent shape", "latent layout", "latent dtype",
                                  "timestep dtype",
                                  "timestep shape", "context shape", "context dtype", "mode",
                                  "direction", "stereo_active", "cudnn switches",
                                  "attention route"])
def test_graph_key_separates(what, monkeypatch):
    """Each of the things a call's launches depend on gives another key."""
    lat, ctx = _inputs()
    base = _key(lat, 601, ctx, STEREO, False)
    if what == "latent shape":
        other = _key(_inputs(size=8)[0], 601, ctx, STEREO, False)
    elif what == "latent layout":
        other = _key(lat.contiguous(memory_format=torch.channels_last), 601, ctx, STEREO, False)
    elif what == "latent dtype":
        other = _key(lat.to(torch.bfloat16), 601, ctx, STEREO, False)
    elif what == "timestep dtype":
        other = _key(lat, 601.0, ctx, STEREO, False)
    elif what == "timestep shape":
        other = _key(lat, torch.full((4,), 601), ctx, STEREO, False)
    elif what == "context shape":
        other = _key(lat, 601, ctx[:, :12], STEREO, False)
    elif what == "context dtype":
        other = _key(lat, 601, ctx.to(torch.bfloat16), STEREO, False)
    elif what == "mode":
        other = _key(lat, 601, ctx, AttentionMode(), False)
    elif what == "direction":
        other = _key(lat, 601, ctx, dataclasses.replace(STEREO, direction="bi"), False)
    elif what == "stereo_active":
        other = _key(lat, 601, ctx, STEREO, True)
    elif what == "cudnn switches":
        monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
        other = _key(lat, 601, ctx, STEREO, False)
    else:
        monkeypatch.setattr(fa, "flash_attention", fa.reference)
        other = _key(lat, 601, ctx, STEREO, False)
    assert other != base


class _StandIn:
    """A captured forward's stand-in: the eager forward, counted."""

    made = []

    def __init__(self, unet, dtype, latents, t, context, mode, stereo_active):
        self.unet, self.dtype, self.mode, self.active = unet, dtype, mode, stereo_active
        _StandIn.made.append(tuple(latents.shape))

    def __call__(self, latents, t, context):
        return self.unet(latents.to(self.dtype), t, context.to(self.dtype), mode=self.mode,
                         stereo_active=self.active).float()


def test_graphed_unet_keeps_its_newest_graphs(bundles, monkeypatch):
    """With graphs allowed (a stand-in for the capture), a key's first call
    captures and every call is served by its key's graph; a call on a key
    held already captures nothing; past `MAX_GRAPHS` keys the least
    recently used graph is dropped, and its key captures again."""
    monkeypatch.setattr(sd_unet, "graphable", lambda *a: True)
    monkeypatch.setattr(sd_unet, "_CapturedForward", _StandIn)
    monkeypatch.setattr(_StandIn, "made", [])
    apply = sd_unet.GraphedUNet(bundles[torch.float32].unet, torch.float32)
    calls0 = sd_unet.UNET_GRAPH_CALLS
    for s in (8, 16, 24, 32):
        lat, ctx = _inputs(batch=2, size=s)
        out = apply(lat, 11, ctx)
        assert torch.equal(out, apply.eager(lat, 11, ctx, AttentionMode(), False))
    assert len(apply.graphs) == sd_unet.MAX_GRAPHS == 4
    lat, ctx = _inputs(batch=2, size=8, seed=1)
    apply(lat, 5, ctx)  # a hit: 8 is the newest now
    assert len(_StandIn.made) == 4
    lat, ctx = _inputs(batch=2, size=40)
    apply(lat, 5, ctx)  # drops 16, the oldest
    assert len(apply.graphs) == 4
    assert [k[1][-1] for k in apply.graphs] == [24, 32, 8, 40]  # by the latents' shape
    lat, ctx = _inputs(batch=2, size=16)
    apply(lat, 5, ctx)
    assert [s[-1] for s in _StandIn.made] == [8, 16, 24, 32, 40, 16]
    assert sd_unet.UNET_GRAPH_CALLS == calls0 + 7


@pytest.mark.parametrize("dim", [8, 32, 320, 321])
def test_timestep_frequencies_held_on_the_device_give_the_same_bits(dim):
    """`sd_timestep_embedding` with the frequencies held once per (width,
    device) equals the form that built them at every call, and a second
    call takes the same tensor."""
    t = torch.tensor([0, 1, 21, 601, 999])
    half = dim // 2
    log10k = torch.log(torch.tensor(10000.0, dtype=torch.float32))
    freqs = torch.exp(-log10k * torch.arange(half, dtype=torch.float32) / half)
    args = t.float()[:, None] * freqs.to(t.device)[None, :]
    want = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    assert torch.equal(sd_unet.sd_timestep_embedding(t, dim), want)
    assert torch.equal(sd_unet.timestep_freqs(dim, "cpu"), freqs)
    assert sd_unet.timestep_freqs(dim, "cpu") is sd_unet.timestep_freqs(dim, t.device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 32, 6, 5), (1, 64, 3, 3), (3, 16, 4)])
def test_group_norm_statistics_spread_per_channel_as_before(dtype, shape):
    """The group norm spreads each group's statistics over its channels by
    a view (no host sync under capture); the output equals the former
    `repeat_interleave` form bit for bit."""
    gen = torch.Generator().manual_seed(3)
    gn = sd_unet.GroupNorm(8, shape[1], 1e-5)
    with torch.no_grad():
        gn.weight.copy_(torch.randn(shape[1], generator=gen))
        gn.bias.copy_(torch.randn(shape[1], generator=gen))
    gn = gn.to(dtype)
    x = torch.randn(shape, generator=gen).to(dtype)
    b, c = shape[:2]
    ones = (1,) * (x.dim() - 2)

    def to_channels(t):
        return t.repeat_interleave(c // 8, dim=1).reshape((b, c) + ones)

    want = sd_unet._normalize(x, x.float().reshape(b, 8, -1), to_channels, gn.weight,
                              gn.bias, gn.eps, (1, c) + ones)
    assert torch.equal(gn(x), want)
