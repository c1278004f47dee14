"""Port's StereoImageNode vs the JAX package's node: contract, outputs,
depth resizing (JAX's bilinear resize antialiases when it downsamples), and
the device rule."""
import jax
import numpy as np
import pytest
import torch

from comfystereo_tpu.nodes import stereo_image as jnode
from comfystereo_tpu.utils import fixtures
from comfystereo_tpu_torch.nodes import stereo_image as tnode

H, W = 48, 64


def test_contract_equal():
    assert tnode.StereoImageNode.INPUT_TYPES() == jnode.StereoImageNode.INPUT_TYPES()
    for attr in ("RETURN_TYPES", "RETURN_NAMES", "FUNCTION", "CATEGORY"):
        assert getattr(tnode.StereoImageNode, attr) == getattr(
            jnode.StereoImageNode, attr)
    assert tnode.NODE_CLASS_MAPPINGS.keys() == jnode.NODE_CLASS_MAPPINGS.keys()
    assert tnode.NODE_DISPLAY_NAME_MAPPINGS == jnode.NODE_DISPLAY_NAME_MAPPINGS


def test_top_level_registration_equals_jax():
    """The package registers the three node groups as the JAX package does
    (comfystereo_tpu/__init__.py:24-62): five nodes, three flags, and
    apply_stereo_divergence exported."""
    import comfystereo_tpu as cs
    import comfystereo_tpu_torch as ct

    assert sorted(ct.NODE_CLASS_MAPPINGS) == sorted(cs.NODE_CLASS_MAPPINGS)
    assert len(ct.NODE_CLASS_MAPPINGS) == 5
    assert ct.NODE_DISPLAY_NAME_MAPPINGS == cs.NODE_DISPLAY_NAME_MAPPINGS
    for flag in ("STEREO_NODES_AVAILABLE", "DIFFUSION_NODES_AVAILABLE",
                 "VR_NODES_AVAILABLE"):
        assert getattr(ct, flag) is getattr(cs, flag) is True, flag
    for name, cls in ct.NODE_CLASS_MAPPINGS.items():
        assert cls.__module__.startswith("comfystereo_tpu_torch."), name
        assert cls.INPUT_TYPES() == cs.NODE_CLASS_MAPPINGS[name].INPUT_TYPES(), name
    from comfystereo_tpu_torch.pipeline import apply_stereo_divergence
    assert ct.apply_stereo_divergence is apply_stereo_divergence


def _close_to_jax(got, want):
    """Blur-on slice tolerances: depth atol 1e-5, mask <= 0.1% mismatch,
    trunc(x*255) within 1 LSB on >= 99.9% of values."""
    stereo, ld, rd, mask = got
    w_stereo, w_ld, w_rd, w_mask = want
    for g in got:
        assert isinstance(g, torch.Tensor) and g.device.type == "cpu"
        assert g.dtype == torch.float32
    assert stereo.shape == w_stereo.shape and mask.shape == w_mask.shape
    np.testing.assert_allclose(ld.numpy(), w_ld, rtol=0, atol=1e-5)
    np.testing.assert_allclose(rd.numpy(), w_rd, rtol=0, atol=1e-5)
    assert (mask.numpy() != w_mask).mean() <= 0.001
    q = np.abs(np.trunc(stereo.numpy() * 255) - np.trunc(w_stereo * 255))
    assert (q <= 1).mean() >= 0.999


def test_generate_matches_jax_in_chunks():
    """batch_size=2 over 3 frames: a full chunk and a short one."""
    imgs, depths = fixtures.batch_fixture(3, H, W, seed=2)
    depth_rgb = np.repeat(depths[..., None], 3, axis=-1)  # gray conversion
    kw = dict(modes="left-right", batch_size=2)
    want = jnode.StereoImageNode().generate(imgs, depth_rgb, **kw)
    got = tnode.StereoImageNode().generate(torch.from_numpy(imgs), depth_rgb,
                                           device="cpu", **kw)
    assert got[0].shape == (3, H, 2 * W, 3) and got[1].shape == (3, H, W, 3)
    _close_to_jax(got, want)


@pytest.mark.parametrize("dh,dw", [(24, 32), (96, 128), (40, 80)])
def test_generate_resized_depth_matches_jax(dh, dw):
    """Upscaled (24x32), downscaled (96x128) and mixed (40x80) depth maps."""
    imgs, _ = fixtures.batch_fixture(2, H, W, seed=4)
    _, small = fixtures.batch_fixture(2, dh, dw, seed=4)
    want_rs = np.asarray(jax.image.resize(small, (2, H, W), "bilinear"))
    got_rs = tnode._resize_bilinear(torch.from_numpy(small), H, W).numpy()
    np.testing.assert_allclose(got_rs, want_rs, rtol=0, atol=1e-5)
    want = jnode.StereoImageNode().generate(imgs, small, modes="top-bottom")
    got = tnode.StereoImageNode().generate(imgs, small, modes="top-bottom",
                                           device="cpu")
    assert got[0].shape == (2, 2 * H, W, 3)
    _close_to_jax(got, want)


def test_generate_unported_fill_raises():
    """Every fill the node offers is ported: none reaches the unported
    supersampled polylines (the node keeps polylines_exact=True), and
    "Fill - Polylines Sharp" matches the JAX node (stereo bit-equal in uint8,
    x255; mask bit-equal; depth outputs atol 1e-5)."""
    offered = jnode.StereoImageNode.INPUT_TYPES()["required"]["fill_technique"][0]
    assert len(offered) == 8
    assert tnode.StereoImageNode.INPUT_TYPES()["required"]["fill_technique"][0] == offered
    imgs, depths = fixtures.batch_fixture(2, H, W, seed=6)
    kw = dict(fill_technique="Fill - Polylines Sharp", modes="left-right")
    want = jnode.StereoImageNode().generate(imgs, depths, **kw)
    got = tnode.StereoImageNode().generate(imgs, depths, device="cpu", **kw)
    assert got[0].shape == (2, H, 2 * W, 3) and got[3].shape == (2, H, 2 * W)
    np.testing.assert_array_equal(np.round(got[0].numpy() * 255.0),
                                  np.round(want[0] * 255.0))
    np.testing.assert_array_equal(got[3].numpy(), want[3])
    np.testing.assert_allclose(got[1].numpy(), want[1], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[2].numpy(), want[2], rtol=0, atol=1e-5)


def test_generate_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is valid")
    imgs, depths = fixtures.batch_fixture(1, H, W)
    with pytest.raises(RuntimeError, match="CUDA"):
        tnode.StereoImageNode().generate(imgs, depths)
