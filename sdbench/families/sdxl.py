"""Stable Diffusion XL base: CLIP-L and OpenCLIP bigG, the conditional
UNet with its text-time embedding, and the VAE decoder in the port's
``StableDiffusionXLPipeline``."""

from sdbench.harness import build, work
from sdbench.reference.pipeline import Reference


def pipeline(cfg: dict, seed: int, device):
    from ml_stable_diffusion_torch.pipelines import StableDiffusionXLPipeline

    enc = {e["role"]: build.port_module("clip", e, seed, device) for e in cfg["text_encoders"]}
    tok = build.tokenizer(cfg["tokenizer"])
    return build.check_stated(StableDiffusionXLPipeline(
        tokenizer=tok, tokenizer2=tok, text_encoder=enc["text_encoder"],
        text_encoder2=enc["text_encoder2"],
        unet=build.port_module("unet", cfg["unet"], seed, device),
        vae_decoder=build.port_module("vae_decoder", cfg["vae_decoder"], seed, device),
        device=device), cfg)


def reference(cfg: dict, seed: int, device) -> Reference:
    return Reference(cfg, seed, device)


def model_flops(cfg: dict) -> dict[str, float]:
    return work.unet_model_flops(cfg)


def flash_calls(cfg: dict, images: int) -> list[tuple]:
    return work.unet_flash_calls(cfg, images)
