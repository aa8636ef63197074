"""SD3 pipeline: MMDiT, three text encoders and rectified flow (port of
ml_stable_diffusion_tpu/pipelines/sd3.py).

What differs from the SD-2.x pipeline it extends:

- two CLIP tokenizers and encoders, CLIP-L and OpenCLIP bigG, and an
  optional T5 tokenizer and encoder.  The context is the CLIPs' penultimate
  states concatenated (768 + 1280), zero-padded to the MMDiT's
  ``context_dim``, followed by a T5 block of exactly ``t5_sequence_length``
  positions: the T5 encoder's states over ids and a mask tokenized to that
  length, or zeros without T5 ((2, 77 + 77, 4096) for SD3-medium).  The
  pooled vector is both CLIPs' pooled outputs concatenated (768 + 1280 =
  2048) and conditions every denoiser call beside the context;
- the DiscreteFlow scheduler only (the configuration default "PNDM" maps to
  it), with ``timestep_shift`` and float timesteps; img2img strength slices
  its sigma grid;
- 16 latent channels, latent scale 1.5305 and shift 0.0609.  The decoder
  takes ``z / scale + shift``; img2img encodes ``z0 = sample * scale``
  without the shift, as the JAX SD3 pipeline does (the shared encode stage
  of its SD pipeline);
- SD3 ControlNets (models/controlnet_sd3.py) need a ``vae_encoder``: each
  control image (as ``_ctrl_images`` reads it, in [0, 1] as the JAX pipeline
  feeds it) is VAE-encoded once per generation, the distribution's mean
  taken, ``(mean - 0.0609) * scale`` for a net with
  ``force_zeros_for_pooled_projection`` false and ``mean * scale`` for one
  with it true (``scale``: ``encoder_scale_factor`` or 1.5305); the nets run
  on the positive conditioning, a ``force_zeros`` net with a zeroed pooled
  vector, and their residuals add to the MMDiT's latent stream.

``deepcache_interval > 1`` raises ``ValueError``, as in the JAX pipeline.
``enable_w8a8`` (inherited) serves the MMDiT's layers as int8, the 2x2
patch convolution too with ``include_convs``.
LoRA adapters address the MMDiT as ``transformer`` (kohya
``lora_transformer_``, PEFT ``transformer.``); ``load_ip_adapter`` raises
``ValueError``: the IP-Adapter checkpoints are UNets'.  A textual-inversion
placeholder reaches the two CLIP tokenizers; T5 reads its text as it is.

The MMDiT with its multi-stream attention, T5-XXL and the SD3 ControlNets
run inside the generation's program.  Under ``reduce_memory`` the encode
stage also takes T5 and, with ControlNets, the VAE encoder that encodes
their control images (the JAX ``_stage_bundle`` leaves both out, and its
staged SD3 encode would miss them).
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
    _LORA_DENOISER_TARGET = "transformer"

    def __init__(self, *, tokenizer, tokenizer2, text_encoder, text_encoder2, mmdit,
                 vae_decoder, t5_tokenizer=None, t5_encoder=None, vae_encoder=None,
                 safety_checker=None, controlnets=(), scheduler_config=None,
                 t5_sequence_length: int = 77, device: str | torch.device = "cuda"):
        if controlnets and vae_encoder is None:
            raise ValueError("SD3 ControlNet conditions on VAE-encoded control latents; "
                             "pass vae_encoder")
        super().__init__(tokenizer=tokenizer, text_encoder=text_encoder, unet=mmdit,
                         vae_decoder=vae_decoder, vae_encoder=vae_encoder,
                         safety_checker=safety_checker, controlnets=controlnets,
                         scheduler_config=scheduler_config, device=device)
        self.tokenizer2 = tokenizer2
        self.text_encoder2 = text_encoder2.to(self.device).eval()
        self.t5_tokenizer = t5_tokenizer
        self.t5_encoder = None if t5_encoder is None else t5_encoder.to(self.device).eval()
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
        """Both CLIP tokenizers over [negatives, positives], truncated to 77
        tokens as the JAX SD3 pipeline does (no prompt-weight parsing), and
        with T5 its ids and mask at ``t5_sequence_length``."""
        neg, pos = self._prompt_lists(cfg)
        out = {"ids": np.stack([self.tokenizer.tokenize(t, TEXT_LEN)[0] for t in neg + pos]),
               "ids2": np.stack([self.tokenizer2.tokenize(t, TEXT_LEN)[0] for t in neg + pos])}
        if self.t5_encoder is not None:
            rows = [self.t5_tokenizer.tokenize(t, self.t5_sequence_length) for t in neg + pos]
            out["ids_t5"] = np.stack([ids for ids, _ in rows])
            out["mask_t5"] = np.stack([mask for _, mask in rows])
        return out

    def _encode_text(self, token_inputs: dict) -> dict:
        out1 = self.text_encoder(self._ids(token_inputs, "ids"))
        out2 = self.text_encoder2(self._ids(token_inputs, "ids2"))
        clip_ctx = torch.cat([out1["penultimate_hidden_state"],
                              out2["penultimate_hidden_state"]], dim=-1)
        clip_ctx = F.pad(clip_ctx, (0, self.context_dim - clip_ctx.shape[-1]))
        L = self.t5_sequence_length
        if self.t5_encoder is not None:
            t5 = self.t5_encoder(self._ids(token_inputs, "ids_t5"),
                                 self._ids(token_inputs, "mask_t5"))
            # exactly L positions, a longer encoder output truncated
            t5_states = t5["encoder_hidden_states"][:, :L].to(clip_ctx.dtype)
        else:
            # no T5: a zero block keeps the context at 77 + L positions, as
            # the reference does
            t5_states = clip_ctx.new_zeros(clip_ctx.shape[0], L, self.context_dim)
        return {"context": torch.cat([clip_ctx, t5_states], dim=1),
                "pooled": torch.cat([out1["pooled_output"], out2["pooled_output"]], dim=-1)}

    def _phase_conditioning(self, cfg: PipelineConfiguration, text: dict, N: int,
                            phase: str):
        ctx_neg, ctx_pos = self._split_neg_pos(text["context"], N)
        pooled_neg, pooled_pos = self._split_neg_pos(text["pooled"], N)
        return ctx_neg, ctx_pos, {"pooled": pooled_neg}, {"pooled": pooled_pos}

    def _call_unet(self, phase: str, latents, t, context, added_cond, down_res=None,
                   mid_res=None, **unet_kw):
        # the nets' residuals, no mid residual and no DeepCache
        # (supports_deepcache)
        return self.unet(latents, t, context, added_cond["pooled"],
                         controlnet_residuals=down_res)

    def _prepare_control_inputs(self, cfg: PipelineConfiguration, ctrl_images):
        """Each control image VAE-encoded to its distribution's mean, scaled
        as its net was trained: without the shift for a ``force_zeros``
        (InstantX) net, with it otherwise."""
        scale = cfg.encoder_scale_factor or self.default_latent_scale
        out = []
        for net, image in zip(self.controlnets, ctrl_images):
            mean = self.vae_encoder(image).chunk(2, dim=1)[0]
            if not net.config.force_zeros_for_pooled_projection:
                mean = mean - self.default_latent_shift
            out.append(mean * scale)
        return out

    def _call_controlnet(self, ci: int, latents_in, t, ctx_pos, added_pos, ctrl_latents):
        net = self.controlnets[ci]
        pooled = added_pos["pooled"]
        if net.config.force_zeros_for_pooled_projection:
            # InstantX SD3 nets were trained with zeroed pooled projections
            pooled = torch.zeros_like(pooled)
        return net(latents_in, t, ctx_pos, pooled, ctrl_latents)

    # -- programs and stages -------------------------------------------------------

    def _params_bundle(self) -> dict:
        b = super()._params_bundle()
        b["text_encoder2"] = [self.text_encoder2]
        if self.t5_encoder is not None:
            b["t5"] = [self.t5_encoder]
        return b

    def _stage_bundle(self, stage: str, img2img: bool = False, n_ctrl: int = 0) -> dict:
        b = super()._stage_bundle(stage, img2img, n_ctrl)
        if stage == "encode":
            full = self._params_bundle()
            for key, needed in (("t5", True), ("vae_encoder", n_ctrl > 0)):
                if needed and key in full:
                    b[key] = full[key]
        return b

    def _conditioning_cache_key(self, cfg: PipelineConfiguration):
        return (self.t5_encoder is not None,)
