"""The diffusion stack of the port: the StereoDiffusion Fast path.

SD UNet and VAE (`sd_unet.py`, `sd_vae.py`) with BN attention
(`attention.py`), whose bf16 self-attentions run the flash kernel
(`kernels/flash_attention.py`); the schedulers; the model bundle and weight
carry-over (`models.py`, `porting.py`); and the warp + inpaint pipeline
(`sd_pipeline.py`).
"""
from .attention import AttentionMode, bn_attention, standard_attention  # noqa: F401
from .models import LATENT_SCALE, DiffusionModel, HashTextEncoder  # noqa: F401
from .porting import build_sd_model, state_dict_from_jax  # noqa: F401
from .sd_pipeline import (StereoResult, backward_warp_right,  # noqa: F401
                          border_prefill, diffusion_inpaint, warp_inpaint)
from .sd_unet import (SD15_INPAINT_UNET_CONFIG, SD15_UNET_CONFIG,  # noqa: F401
                      SD21_UNET_CONFIG, TINY_SD_UNET_CONFIG, SDUNet, SDUNetConfig)
from .sd_vae import SD_VAE_CONFIG, TINY_SD_VAE_CONFIG, SDVAE, SDVAEConfig  # noqa: F401
