"""SD3 txt2img pipeline: MMDiT, two CLIP encoders and rectified flow (port
of ml_stable_diffusion_tpu/pipelines/sd3.py, without T5 for now).

What differs from the SD-2.x pipeline it extends:

- two tokenizers and encoders, CLIP-L and OpenCLIP bigG.  The context is
  their penultimate states concatenated (768 + 1280), zero-padded to the
  MMDiT's ``context_dim``, followed by a zero T5 block of
  ``t5_sequence_length`` positions: (2, 77 + 77, 4096) for SD3-medium.  The
  pooled vector is both encoders' pooled outputs concatenated (768 + 1280 =
  2048) and conditions every denoiser call beside the context;
- the DiscreteFlow scheduler only (the configuration default "PNDM" maps to
  it), with ``timestep_shift`` and float timesteps; img2img strength slices
  its sigma grid;
- 16 latent channels, latent scale 1.5305 and shift 0.0609.  The decoder
  takes ``z / scale + shift``; img2img encodes ``z0 = sample * scale``
  without the shift, as the JAX SD3 pipeline does (the shared encode stage
  of its SD pipeline).

The T5 encoder and tokenizer and SD3 ControlNet raise
``NotImplementedError`` naming their ROADMAP.md items; ``deepcache_interval
> 1`` raises ``ValueError``, as in the JAX pipeline.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .config import PipelineConfiguration
from .sd import TEXT_LEN, StableDiffusionPipeline


class StableDiffusion3Pipeline(StableDiffusionPipeline):
    default_latent_scale = 1.5305
    default_latent_shift = 0.0609
    latent_channels = 16
    #: a uniform transformer stack: no shallow/deep split for DeepCache
    supports_deepcache = False

    def __init__(self, *, tokenizer, tokenizer2, text_encoder, text_encoder2, mmdit,
                 vae_decoder, t5_tokenizer=None, t5_encoder=None, vae_encoder=None,
                 safety_checker=None, controlnets=(), scheduler_config=None,
                 t5_sequence_length: int = 77, device: str | torch.device = "cuda"):
        if t5_encoder is not None or t5_tokenizer is not None:
            raise NotImplementedError("the T5 encoder and tokenizer: ROADMAP Queue 1 item 14")
        if controlnets:
            raise NotImplementedError("SD3 ControlNet: ROADMAP Queue 1 item 14")
        super().__init__(tokenizer=tokenizer, text_encoder=text_encoder, unet=mmdit,
                         vae_decoder=vae_decoder, vae_encoder=vae_encoder,
                         safety_checker=safety_checker,
                         scheduler_config=scheduler_config, device=device)
        self.tokenizer2 = tokenizer2
        self.text_encoder2 = text_encoder2.to(self.device).eval()
        self.t5_sequence_length = t5_sequence_length
        self.context_dim = mmdit.config.context_dim

    def _scheduler_name(self, cfg: PipelineConfiguration) -> str:
        """Rectified flow only; the configuration default "PNDM" maps to it."""
        name = "DiscreteFlow" if cfg.scheduler == "PNDM" else cfg.scheduler
        if name != "DiscreteFlow":
            raise ValueError(f"SD3 supports only the DiscreteFlow scheduler, "
                             f"got {cfg.scheduler!r}")
        return name

    def _tokenize(self, cfg: PipelineConfiguration) -> dict:
        """Both tokenizers over [negatives, positives], truncated to 77
        tokens as the JAX SD3 pipeline does (no prompt-weight parsing)."""
        neg, pos = self._prompt_lists(cfg)
        return {"ids": np.stack([self.tokenizer.tokenize(t, TEXT_LEN)[0] for t in neg + pos]),
                "ids2": np.stack([self.tokenizer2.tokenize(t, TEXT_LEN)[0]
                                  for t in neg + pos])}

    def _encode_text(self, token_inputs: dict) -> dict:
        out1 = self.text_encoder(self._ids(token_inputs, "ids"))
        out2 = self.text_encoder2(self._ids(token_inputs, "ids2"))
        clip_ctx = torch.cat([out1["penultimate_hidden_state"],
                              out2["penultimate_hidden_state"]], dim=-1)
        clip_ctx = F.pad(clip_ctx, (0, self.context_dim - clip_ctx.shape[-1]))
        # no T5: a zero block keeps the context at 77 + L positions, as the
        # reference does
        t5_zero = clip_ctx.new_zeros(clip_ctx.shape[0], self.t5_sequence_length,
                                     self.context_dim)
        return {"context": torch.cat([clip_ctx, t5_zero], dim=1),
                "pooled": torch.cat([out1["pooled_output"], out2["pooled_output"]], dim=-1)}

    def _phase_conditioning(self, cfg: PipelineConfiguration, text: dict, N: int,
                            phase: str):
        ctx_neg, ctx_pos = self._split_neg_pos(text["context"], N)
        pooled_neg, pooled_pos = self._split_neg_pos(text["pooled"], N)
        return ctx_neg, ctx_pos, {"pooled": pooled_neg}, {"pooled": pooled_pos}

    def _call_unet(self, phase: str, latents, t, context, added_cond, down_res=None,
                   mid_res=None, **unet_kw):
        # no ControlNet residuals (the constructor refuses SD3 ControlNets)
        # and no DeepCache (supports_deepcache)
        return self.unet(latents, t, context, added_cond["pooled"])
