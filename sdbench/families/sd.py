"""Stable Diffusion 1.x and 2.x: one CLIP text encoder, the conditional
UNet and the VAE decoder in the port's ``StableDiffusionPipeline``."""

from sdbench.harness import build, work
from sdbench.reference.pipeline import Reference


def pipeline(cfg: dict, seed: int, device):
    from ml_stable_diffusion_torch.pipelines import StableDiffusionPipeline

    (enc,) = cfg["text_encoders"]
    return build.check_stated(StableDiffusionPipeline(
        tokenizer=build.tokenizer(cfg["tokenizer"]),
        text_encoder=build.port_module("clip", enc, seed, device),
        unet=build.port_module("unet", cfg["unet"], seed, device),
        vae_decoder=build.port_module("vae_decoder", cfg["vae_decoder"], seed, device),
        text_embedding_key=enc["output"], device=device), cfg)


def reference(cfg: dict, seed: int, device) -> Reference:
    return Reference(cfg, seed, device)


def model_flops(cfg: dict) -> dict[str, float]:
    return work.unet_model_flops(cfg)


def flash_calls(cfg: dict, images: int) -> list[tuple]:
    return work.unet_flash_calls(cfg, images)
