"""Port config vs the JAX package's config: fields, defaults, validation,
UI mapping, and carrying a configuration across with config_from_fields."""
import dataclasses

import pytest

from comfystereo_tpu import config as jcfg
from comfystereo_tpu_torch import config as tcfg


def test_constants_equal():
    assert tcfg.MODES == jcfg.MODES
    assert tcfg.FILL_TECHNIQUES == jcfg.FILL_TECHNIQUES
    assert tcfg.UI_FILL_MAPPING == jcfg.UI_FILL_MAPPING


def test_fields_and_defaults_equal():
    jf = [(f.name, f.type, f.default) for f in dataclasses.fields(jcfg.StereoConfig)]
    tf = [(f.name, f.type, f.default) for f in dataclasses.fields(tcfg.StereoConfig)]
    assert tf == jf
    assert dataclasses.asdict(tcfg.StereoConfig()) == dataclasses.asdict(
        jcfg.StereoConfig())


@pytest.mark.parametrize("kwargs", [
    dict(color_dtype="float16"),
    dict(fill_technique="bogus"),
    dict(modes=("left-right", "sideways")),
])
def test_same_validation_errors(kwargs):
    with pytest.raises(ValueError) as je:
        jcfg.StereoConfig(**kwargs)
    with pytest.raises(ValueError) as te:
        tcfg.StereoConfig(**kwargs)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("ui", list(jcfg.UI_FILL_MAPPING) + ["unknown name"])
def test_from_ui_matches(ui):
    j = jcfg.StereoConfig.from_ui(ui, divergence=3.0)
    t = tcfg.StereoConfig.from_ui(ui, divergence=3.0)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


@pytest.mark.parametrize("balance", [0.0, 0.5, -0.95])
def test_eye_divergences_match(balance):
    j = jcfg.StereoConfig(divergence=6.0, stereo_balance=balance)
    t = tcfg.StereoConfig(divergence=6.0, stereo_balance=balance)
    assert t.eye_divergences() == j.eye_divergences()


def test_config_from_fields_round_trips():
    j = jcfg.StereoConfig(divergence=7.5, separation=1.0, stereo_balance=0.25,
                          modes=("top-bottom", "red-cyan-anaglyph"),
                          depth_map_blur=False, batch_size=4,
                          color_dtype="bfloat16")
    t = tcfg.config_from_fields(j)
    assert isinstance(t, tcfg.StereoConfig)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    # and back: the JAX config rebuilt from the port's fields is equal
    assert jcfg.StereoConfig(**dataclasses.asdict(t)) == j
    # a plain dict (modes as a list, as JSON gives it) works too
    d = dataclasses.asdict(j)
    d["modes"] = list(d["modes"])
    assert tcfg.config_from_fields(d) == t


def test_config_from_fields_rejects_unknown():
    with pytest.raises(TypeError):
        tcfg.config_from_fields({"divergence": 1.0, "not_a_field": 2})
    with pytest.raises(TypeError):
        tcfg.config_from_fields(42)
