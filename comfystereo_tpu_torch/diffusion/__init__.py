"""The diffusion stack of the port: StereoDiffusion's Standard and Fast paths.

SD UNet and VAE (`sd_unet.py`, `sd_vae.py`) with BN attention
(`attention.py`), whose bf16 self-attentions run the flash kernel
(`kernels/flash_attention.py`, differentiable); the CLIP text encoder and
its BPE tokenizer (`clip_text.py`, `clip_tokenizer.py`); the toy model and
the model bundle (`models.py`); checkpoint I/O, the LDM key maps, weight
carry-over and model assembly (`porting.py`), w8 weight storage
(`quantize.py`), hub resolution and the model cache (`model_loader.py`) and
the adapters for connected models (`adapters.py`); the schedulers and step
helpers; the latent stereo shift (`stereo_latent.py`); DDIM inversion with
null-text optimisation (`inversion.py`); and the Standard (`text2stereo`)
and warp + inpaint pipelines (`sd_pipeline.py`).
"""
from . import adapters, helpers, inversion, model_loader, quantize  # noqa: F401
from . import clip_text, clip_tokenizer  # noqa: F401
from .adapters import SUPPORTED_MODEL_TYPES, detect_model_type  # noqa: F401
from .attention import AttentionMode, bn_attention, standard_attention  # noqa: F401
from .clip_text import (SD15_TEXT_CONFIG, SD21_TEXT_CONFIG,  # noqa: F401
                        TINY_TEXT_CONFIG, CLIPTextConfig, CLIPTextModel,
                        NativeCLIPTextEncoder)
from .clip_tokenizer import CLIPBPETokenizer  # noqa: F401
from .helpers import diffusion_step, diffusion_step_no_cfg, init_latent  # noqa: F401
from .inversion import InversionResult, invert  # noqa: F401
from .models import (LATENT_SCALE, SDXL_LATENT_SCALE, DiffusionModel,  # noqa: F401
                     HashTextEncoder, LatentUNet, SimpleVAE, UNetConfig, make_toy_model)
from .porting import (build_sd_model, load_sd_from_diffusers_dir,  # noqa: F401
                      state_dict_from_jax, toy_state_dicts_from_jax)
from .sd_pipeline import (StereoResult, backward_warp_right,  # noqa: F401
                          border_prefill, diffusion_inpaint, text2stereo, warp_inpaint)
from .sd_unet import (SD15_INPAINT_UNET_CONFIG, SD15_UNET_CONFIG,  # noqa: F401
                      SD21_UNET_CONFIG, SDXL_INPAINT_UNET_CONFIG, TINY_SD_UNET_CONFIG,
                      SDUNet, SDUNetConfig)
from .sd_vae import SD_VAE_CONFIG, TINY_SD_VAE_CONFIG, SDVAE, SDVAEConfig  # noqa: F401
from .stereo_latent import stereo_shift, stereo_shift_with_mask  # noqa: F401
