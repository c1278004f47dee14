"""Port's hub resolution, model cache and the node's model resolution.

The cases of tests/test_model_loader.py, run against both packages where
they share a surface. No test reaches the network: the hub API is faked
(`huggingface_hub.snapshot_download` replaced), or hidden, as on a machine
without the package. What is pinned: the resolution order (directory ->
local cache -> download with one retry), the offline gate and the attempt
trail (equal to JAX's), the cache keys (per id and scheduler, as JAX keys
them, and per device), the dtype policy, and the node's loud toy fallback.
"""
import importlib.util
import sys

import numpy as np
import pytest
import torch

from comfystereo_tpu.diffusion import model_loader as jloader
from comfystereo_tpu_torch.diffusion import (CLIPTextConfig, NativeCLIPTextEncoder,
                                             SDUNetConfig, SDVAEConfig,
                                             make_toy_model)
from comfystereo_tpu_torch.diffusion import model_loader as tloader
from comfystereo_tpu_torch.diffusion import porting as tporting
from comfystereo_tpu_torch.nodes import stereodiffusion as tnode
from comfystereo_tpu_torch.utils import caching
from torch_checkpoint import toy_vocab, write_sd_dir

BANNER = "FALLING BACK TO THE OFFLINE TOY MODEL"


@pytest.fixture(autouse=True)
def _clean_cache():
    caching.clear_model_cache()
    jloader.clear_model_cache()
    yield
    caching.clear_model_cache()
    jloader.clear_model_cache()


def _fake_hub(monkeypatch, behavior):
    """Replace huggingface_hub.snapshot_download, recording the calls."""
    hub = pytest.importorskip("huggingface_hub")
    calls = []

    def snapshot_download(repo_id, local_files_only=False, allow_patterns=None, **kw):
        calls.append({"repo_id": repo_id, "local_files_only": local_files_only,
                      "allow_patterns": allow_patterns})
        return behavior(repo_id, local_files_only)

    monkeypatch.setattr(hub, "snapshot_download", snapshot_download)
    return calls


def _online(monkeypatch):
    monkeypatch.delenv("HF_HUB_OFFLINE", raising=False)
    monkeypatch.delenv("COMFYSTEREO_OFFLINE", raising=False)


def test_local_dir_passthrough(tmp_path):
    d = tmp_path / "model"
    d.mkdir()
    assert tloader.resolve_model_dir(str(d)) == str(d)


def test_cache_hit_never_downloads(monkeypatch, tmp_path):
    def behavior(repo_id, local_only):
        assert local_only, "must try the local cache first"
        return str(tmp_path)

    calls = _fake_hub(monkeypatch, behavior)
    assert tloader.resolve_model_dir("org/model") == str(tmp_path)
    assert len(calls) == 1 and calls[0]["local_files_only"]
    assert calls[0]["allow_patterns"] == jloader._SD_ALLOW_PATTERNS


def test_download_retries_once(monkeypatch, tmp_path, capsys):
    state = {"n": 0}

    def behavior(repo_id, local_only):
        if local_only:
            raise FileNotFoundError("not cached")
        state["n"] += 1
        if state["n"] == 1:
            raise ConnectionError("flaky network")
        return str(tmp_path)

    calls = _fake_hub(monkeypatch, behavior)
    _online(monkeypatch)
    assert tloader.resolve_model_dir("org/model") == str(tmp_path)
    assert len(calls) == 3  # cache probe + failed download + retry
    assert "Attempting to download from HuggingFace..." in capsys.readouterr().out


def _not_cached(repo_id, local_only):
    if local_only:
        raise FileNotFoundError("not cached")
    raise ConnectionError("no route to host")


def _attempts(loader, model_id):
    with pytest.raises(loader.ModelUnavailableError) as ei:
        loader.resolve_model_dir(model_id)
    return ei.value.attempts, str(ei.value)


@pytest.mark.parametrize("offline", [True, False])
def test_attempt_trail_equals_jax(monkeypatch, offline, capsys):
    """Offline: the cache probe and the gate; online: the probe and two
    download tries. The trail and message are JAX's, word for word."""
    calls = _fake_hub(monkeypatch, _not_cached)
    if offline:
        monkeypatch.setenv("COMFYSTEREO_OFFLINE", "1")
    else:
        _online(monkeypatch)
    got, want = _attempts(tloader, "org/model"), _attempts(jloader, "org/model")
    assert got == want
    if offline:
        assert "offline mode" in got[1] and "local cache" in got[1]
        assert all(c["local_files_only"] for c in calls)
    else:
        assert "download try 1" in got[1] and "download try 2" in got[1]
    capsys.readouterr()


def test_filesystem_path_never_hits_hub(monkeypatch):
    def behavior(repo_id, local_only):
        raise AssertionError("a filesystem path reached the hub API")

    _fake_hub(monkeypatch, behavior)
    with pytest.raises(tloader.ModelUnavailableError, match="not a directory on disk"):
        tloader.resolve_model_dir("/no/such/model/dir")


def test_missing_hub_package_is_unavailable(monkeypatch):
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    got, want = _attempts(tloader, "org/model"), _attempts(jloader, "org/model")
    assert got == want and got[0][0].startswith("huggingface_hub missing")


@pytest.fixture
def fake_load(monkeypatch):
    """Replace porting.load_sd_from_diffusers_dir, recording (dir, dtype,
    device) and returning a fresh toy bundle."""
    loads = []

    def load(model_dir, dtype=None, device=None, **kw):
        loads.append((model_dir, dtype, torch.device(device)))
        return make_toy_model(image_size=64, device=device)

    monkeypatch.setattr(tporting, "load_sd_from_diffusers_dir", load)
    return loads


def test_load_sd_model_caches_per_scheduler_and_device(fake_load, tmp_path):
    d = str(tmp_path)
    m1 = tloader.load_sd_model(d, "ddim", device="cpu")
    assert tloader.load_sd_model(d, "ddim", device="cpu") is m1
    m2 = tloader.load_sd_model(d, "euler", device="cpu")
    m3 = tloader.load_sd_model(d, "ddim", device="meta")
    mi = tloader.load_inpainting_model(d, device="cpu")
    assert len({id(m) for m in (m1, m2, m3, mi)}) == 4
    assert tloader.load_inpainting_model(d, device="cpu") is mi
    assert [(x[1], x[2].type) for x in fake_load] == [
        (torch.float32, "cpu"), (torch.bfloat16, "cpu"), (torch.float32, "meta"),
        (torch.bfloat16, "cpu")]
    assert set(caching._model_cache) == {f"{d}:ddim:cpu", f"{d}:euler:cpu", f"{d}:ddim:meta",
                                         f"{d}:inpaint:cpu"}
    caching.clear_model_cache()
    tloader.load_sd_model(d, "ddim", device="cpu")
    assert len(fake_load) == 5
    tloader.load_sd_model(d, "ddim", dtype=torch.bfloat16, device="cpu")  # cached
    assert len(fake_load) == 5


def test_node_falls_back_loudly(monkeypatch, capsys):
    """An unresolvable model_id gives the toy model on the node's device,
    with the banner and the attempt trail printed."""
    _fake_hub(monkeypatch, _not_cached)
    monkeypatch.setenv("COMFYSTEREO_OFFLINE", "1")
    model = tnode._resolve_model(model_id="org/never-exists", device="cpu")
    assert model is tnode._default_model(torch.device("cpu"))
    assert model.device == torch.device("cpu") and model.sample_size == 64
    out = capsys.readouterr().out
    assert BANNER in out and "org/never-exists" in out
    assert "offline mode" in out and "diffusers adapter" in out
    assert tnode._resolve_model(device="cpu") is model  # no id: the toy, quietly
    assert BANNER not in capsys.readouterr().out


@pytest.mark.parametrize("error", [torch.cuda.OutOfMemoryError("CUDA out of memory"),
                                   RuntimeError("CUDA error: an illegal memory access")])
def test_node_lets_device_errors_through(monkeypatch, capsys, error):
    """Only a missing or unusable checkpoint leads to the toy: an error of
    the device while loading propagates, and no banner is printed."""
    def load(*args, **kwargs):
        raise error

    monkeypatch.setattr(tloader, "load_inpainting_model", load)
    with pytest.raises(type(error)):
        tnode._resolve_model(model_id="org/some-model", device="cpu")
    assert BANNER not in capsys.readouterr().out


@pytest.mark.parametrize("mode,dtype", [("Standard (DDIM)", torch.float32),
                                        ("Fast (Warp + Inpaint)", torch.bfloat16)])
def test_node_routes_local_dir_through_the_loader(fake_load, tmp_path, mode, dtype):
    model = tnode._resolve_model(model_id=str(tmp_path), pipeline_mode=mode, device="cpu")
    assert fake_load == [(str(tmp_path), dtype, torch.device("cpu"))]
    assert tnode._resolve_model(model_id=str(tmp_path), pipeline_mode=mode,
                                device="cpu") is model


def test_node_fast_mode_takes_inpaint_model_id(fake_load, tmp_path, capsys):
    sd_dir, inpaint_dir = tmp_path / "sd", tmp_path / "inpaint"
    sd_dir.mkdir()
    inpaint_dir.mkdir()
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 1, (1, 48, 40, 3)).astype(np.float32)
    dep = rng.uniform(0, 1, (1, 48, 40)).astype(np.float32)
    pair, left, right = tnode.StereoDiffusionNode().generate_stereo(
        img, dep, model_id=str(sd_dir), inpaint_model_id=str(inpaint_dir),
        num_inference_steps=3, device="cpu")
    assert fake_load == [(str(inpaint_dir), torch.bfloat16, torch.device("cpu"))]
    assert tuple(pair.shape) == (1, 48, 80, 3) and bool(torch.isfinite(right).all())
    tnode.StereoDiffusionNode().generate_stereo(
        img, dep, model_id=str(sd_dir), inpaint_model_id=str(inpaint_dir),
        pipeline_mode="Standard (DDIM)", num_inference_steps=2,
        null_text_optimization=False, device="cpu")
    assert fake_load[1] == (str(sd_dir), torch.float32, torch.device("cpu"))
    assert BANNER not in capsys.readouterr().out


SMALL_UNET = SDUNetConfig(in_channels=9, block_out_channels=(32, 64), layers_per_block=1,
                          cross_attention_dim=64, attention_head_dim=8)
SMALL_VAE = SDVAEConfig(block_out_channels=(32, 64), layers_per_block=1)
SMALL_TEXT = CLIPTextConfig(vocab_size=96, hidden_size=64, num_hidden_layers=1,
                            num_attention_heads=4, intermediate_size=64)


def test_load_inpainting_model_from_a_directory(tmp_path):
    """A directory whose configs the shapes give (SD1 heads, 32 groups)
    through the real loader: bf16 on the CPU, the checkpoint's CLIP, one
    bundle per key."""
    write_sd_dir(str(tmp_path), SMALL_UNET, SMALL_VAE, SMALL_TEXT, toy_vocab(), seed=4)
    m = tloader.load_inpainting_model(str(tmp_path), device="cpu")
    assert tloader.load_inpainting_model(str(tmp_path), device="cpu") is m
    assert m.unet.cfg == SMALL_UNET and m.vae.cfg == SMALL_VAE
    assert next(m.unet.parameters()).dtype == torch.bfloat16 and m.unet_in_channels == 9
    assert isinstance(m.text_encode, NativeCLIPTextEncoder)
    assert next(m.text_encode.model.parameters()).dtype == torch.bfloat16
    ctx = m.text_encode("low lower")
    assert ctx.dtype == torch.float32 and tuple(ctx.shape) == (1, 77, 64)
    lat = torch.randn(1, 9, 8, 8, generator=torch.Generator().manual_seed(0))
    eps = m.unet_apply(lat, 500, ctx)
    assert eps.dtype == torch.float32 and bool(torch.isfinite(eps).all())
    f32 = tloader.load_sd_model(str(tmp_path), "ddim", device="cpu")
    assert next(f32.unet.parameters()).dtype == torch.float32
    assert next(f32.text_encode.model.parameters()).dtype == torch.float32


def test_clear_model_cache_frees_the_models_at_once(tmp_path):
    """Clearing the one model cache frees a loaded bundle's UNet and CLIP
    tower by reference counting alone: no reference cycle keeps either
    until the garbage collector runs."""
    import gc
    import weakref

    write_sd_dir(str(tmp_path), SMALL_UNET, SMALL_VAE, SMALL_TEXT, toy_vocab(), seed=4)
    m = tloader.load_inpainting_model(str(tmp_path), device="cpu")
    m.text_encode("low")
    refs = [weakref.ref(m.unet), weakref.ref(m.text_encode.model)]
    del m
    gc.disable()
    try:
        caching.clear_model_cache()
        assert [r() for r in refs] == [None, None]
    finally:
        gc.enable()


def test_from_diffusers_is_gated_on_the_package():
    if importlib.util.find_spec("diffusers") is not None:
        pytest.skip("diffusers is installed: the gate is open")
    from comfystereo_tpu_torch.diffusion.adapters import from_diffusers
    with pytest.raises(ImportError):
        from_diffusers("org/model", device="cpu")


def test_node_resolves_connected_torch_modules():
    """A ComfyUI-style MODEL (`.model.diffusion_model`), CLIP (`.tokenizer`,
    `.cond_stage_model`) and VAE go through `from_torch_modules`: the
    weights run in the port's SDUNet on the node's device, the CLIP tower in
    the port's CLIPTextModel."""
    from types import SimpleNamespace

    transformers = pytest.importorskip("transformers")
    from comfystereo_tpu_torch.diffusion import CLIPBPETokenizer, SDUNet
    from torch_ref import TorchSDUNet, TorchSDVAE

    cfg = SDUNetConfig(block_out_channels=(32, 64), layers_per_block=1,
                       cross_attention_dim=64, attention_head_dim=8)
    torch.manual_seed(0)
    unet, vae = TorchSDUNet(cfg).eval(), TorchSDVAE(SMALL_VAE).eval()
    text = transformers.CLIPTextModel(transformers.CLIPTextConfig(
        vocab_size=96, hidden_size=64, num_hidden_layers=1, num_attention_heads=1,
        intermediate_size=64, max_position_embeddings=77)).eval()
    clip = SimpleNamespace(tokenizer=CLIPBPETokenizer(*toy_vocab()), cond_stage_model=text)
    model = tnode._resolve_model(SimpleNamespace(model=SimpleNamespace(diffusion_model=unet)),
                                 clip, vae, device="cpu")
    assert isinstance(model.unet, SDUNet) and model.unet.cfg == cfg
    assert isinstance(model.text_encode, NativeCLIPTextEncoder)
    lat = torch.randn(2, 4, 8, 8, generator=torch.Generator().manual_seed(1))
    ctx = torch.cat([model.text_encode("low"), model.text_encode("")])
    with torch.no_grad():
        want = unet(lat, torch.tensor(250.0), ctx)
    np.testing.assert_allclose(model.unet_apply(lat, 250, ctx).numpy(), want.numpy(),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("entry", ["load_sd_from_diffusers_dir", "load_sd_model",
                                   "load_inpainting_model", "node", "from_torch_modules"])
def test_entry_points_default_to_cuda(tmp_path, entry):
    """device=None means CUDA: without a GPU each entry point raises before
    it reads or builds anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is valid")
    from comfystereo_tpu_torch.diffusion.adapters import from_torch_modules
    calls = {
        "load_sd_from_diffusers_dir": lambda: tporting.load_sd_from_diffusers_dir(str(tmp_path)),
        "load_sd_model": lambda: tloader.load_sd_model(str(tmp_path)),
        "load_inpainting_model": lambda: tloader.load_inpainting_model(str(tmp_path)),
        "node": lambda: tnode.StereoDiffusionNode().generate_stereo(
            np.zeros((1, 8, 8, 3), np.float32), np.zeros((1, 8, 8), np.float32),
            inpaint_model_id=str(tmp_path)),
        "from_torch_modules": lambda: from_torch_modules(None, None, None, None),
    }
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()
