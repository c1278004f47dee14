"""Configuration schema for the PyTorch stereo pipeline.

The port's own copy of `comfystereo_tpu.config`: same fields, defaults,
validation errors, `from_ui` and `eye_divergences`, so a configuration means
the same thing to both packages. It is copied, not imported, because importing
anything under `comfystereo_tpu` loads JAX.

This system has no weights; its state is the configuration. `config_from_fields`
carries a configuration across from the JAX package (or from a plain dict) so
both sides run the same settings.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Tuple

# Output packing modes (reference: stereoimage_generation.py:1544-1560, :1092-1122).
MODES = (
    "left-right",
    "right-left",
    "top-bottom",
    "bottom-top",
    "red-cyan-anaglyph",
    "cyan-red-reverseanaglyph",
    "left-only",
    "only-right",
)

# Engine-level fill technique identifiers
# (reference dispatcher: stereoimage_generation.py:1576-1620).
FILL_TECHNIQUES = (
    "gpu_warp",            # forward warp + z-buffer + border interp (reference :277-450)
    "none",                # naive scatter, gaps left black (reference :1850-1910)
    "naive",               # naive scatter + nearest-neighbor fill
    "naive_interpolating", # naive scatter + linear border interpolation
    "none_post",           # naive scatter + row-wise np.interp post fill (reference :1804)
    "inverse",             # z-buffered sub-pixel splat (reference :1715-1737)
    "inverse_post",        # inverse + row-wise post fill (reference :1820)
    "hybrid_edge",         # Gaussian 3-col splat + edge-aware 2D fill (reference :1837)
    "hybrid_edge_plus",    # hybrid_edge + polylines_soft backfill (reference :1778)
    "polylines_soft",      # scanline polyline renderer (reference :1912-1992)
    "polylines_sharp",
)

# UI-name -> engine-name mapping (reference: GenerateStereo.py:88-102).
UI_FILL_MAPPING = {
    "GPU Warp (Fast)": "gpu_warp",
    "No fill": "none",
    "No fill - Reverse projection": "inverse",
    "Imperfect fill - Hybrid Edge": "hybrid_edge",
    "Fill - Naive": "naive",
    "Fill - Naive interpolating": "naive_interpolating",
    "Fill - Polylines Soft": "polylines_soft",
    "Fill - Polylines Sharp": "polylines_sharp",
    "Fill - Post-fill": "none_post",
    "Fill - Reverse projection with Post-fill": "inverse_post",
    "Fill - Hybrid Edge with fill": "hybrid_edge_plus",
}


@dataclasses.dataclass(frozen=True)
class StereoConfig:
    """Static configuration for depth->stereo conversion.

    Defaults and ranges mirror the reference node schema
    (GenerateStereo.py:61-71); see each field's comment for the source line.
    """

    # 3D effect strength, percent of image width (default 4.5, range 0.05-15).
    divergence: float = 4.5
    # Additional horizontal shift, percent of width (default 0, range -5..5).
    separation: float = 0.0
    # Divergence split between eyes (default 0, range -0.95..0.95):
    #   left = divergence*(1+balance), right = divergence*(1-balance).
    stereo_balance: float = 0.0
    # Depth that maps to the screen plane (default 0.5, range 0..1).
    convergence_point: float = 0.5
    # Depth-to-offset power curve (node default 2, range 0.1-2).
    stereo_offset_exponent: float = 2.0
    # Fill technique (engine name, see FILL_TECHNIQUES).
    fill_technique: str = "gpu_warp"
    # Output packing modes.
    modes: Tuple[str, ...] = ("left-right",)

    # --- depth pre-blur (reference defaults: GenerateStereo.py:66-70) ---
    depth_map_blur: bool = True
    depth_blur_edge_threshold: float = 20.0
    depth_blur_strength: float = 20.0
    depth_blur_falloff: float = 2.0
    depth_blur_vert_smooth: int = 6

    # Frames per device batch (reference default 12).
    batch_size: int = 12

    # --- gpu_warp engine knobs (reference forward_warp_gpu defaults, :277-279) ---
    gradient_threshold: float = 1.5
    max_stretch: int = 8

    # Exact sub-interval integration for the polylines fills (uint8 parity
    # with the reference); False selects the supersampled renderer
    # (ops/polylines.py), an approximation of it.
    polylines_exact: bool = True
    # Supersampling rate for the supersampled polylines renderer.
    polylines_samples: int = 8

    # Color-plane dtype for the gpu_warp path. "bfloat16" halves the bytes
    # of the color reads and writes; geometry and z math stay float32.
    color_dtype: str = "float32"

    def __post_init__(self):
        if self.color_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"unknown color_dtype {self.color_dtype!r}; "
                "expected 'float32' or 'bfloat16'")
        if self.fill_technique not in FILL_TECHNIQUES:
            raise ValueError(
                f"unknown fill_technique {self.fill_technique!r}; "
                f"expected one of {FILL_TECHNIQUES}")
        for m in self.modes:
            if m not in MODES:
                raise ValueError(f"unknown mode {m!r}; expected one of {MODES}")

    @classmethod
    def from_ui(cls, fill_technique_ui: str = "GPU Warp (Fast)", **kw) -> "StereoConfig":
        """Build a config from the UI-level fill technique name."""
        return cls(fill_technique=UI_FILL_MAPPING.get(fill_technique_ui, "gpu_warp"), **kw)

    def eye_divergences(self) -> Tuple[float, float]:
        """(left, right) divergence percentages after stereo_balance split
        (reference: stereoimage_generation.py:1533-1534)."""
        return (self.divergence * (1.0 + self.stereo_balance),
                self.divergence * (1.0 - self.stereo_balance))


def config_from_fields(obj_or_dict: Any) -> StereoConfig:
    """Build the port's StereoConfig from another dataclass config (such as
    the JAX package's) or from a plain mapping of field names to values.

    Unknown keys raise TypeError, as the dataclass constructor does, so a
    field added on one side only is caught rather than dropped.
    """
    if dataclasses.is_dataclass(obj_or_dict) and not isinstance(obj_or_dict, type):
        fields = dataclasses.asdict(obj_or_dict)
    elif isinstance(obj_or_dict, Mapping):
        fields = dict(obj_or_dict)
    else:
        raise TypeError(
            f"expected a dataclass instance or a mapping, got {type(obj_or_dict).__name__}")
    if "modes" in fields:
        fields["modes"] = tuple(fields["modes"])
    return StereoConfig(**fields)
