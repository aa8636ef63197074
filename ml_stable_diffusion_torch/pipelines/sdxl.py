"""SDXL txt2img pipeline, base and optional refiner (port of
ml_stable_diffusion_tpu/pipelines/sdxl.py).

What differs from the SD-2.x pipeline it extends:

- two tokenizers and encoders, CLIP-L (optional) and OpenCLIP bigG.  The
  context is their penultimate states concatenated (768 + 1280 = 2048); the
  pooled vector is bigG's projected pooled output;
- ``force_zeros_for_empty_prompt``: when every negative prompt is "", the
  negative rows of the context and of the pooled vector are zeroed, not the
  encoding of "" (the refiner's own context is left as encoded, as in the JAX
  package);
- micro-conditioning: the base UNet takes time ids ``[original_size,
  crops_coords_top_left, target_size]``, both sizes (1024, 1024) unless set,
  whatever the image size; the refiner takes ``[original_size,
  crops_coords_top_left, aesthetic_score]`` (``negative_aesthetic_score`` for
  the negative rows) and attends to bigG's 1280-wide context alone;
- the base -> refiner handoff: with a refiner, the base UNet runs steps
  ``[0, cut)`` and the refiner ``[cut, n)`` over one scheduler state, ``cut =
  min(n, max(0, int(refiner_start * n)))``;
- latent scale 0.13025.

- prompt weights and long prompts over both encoders: they run over the
  same window count (the shorter tokenization padded with BOS+EOS windows),
  each encoder's states weighted with its own tokenization's weights; the
  pooled vector comes from bigG's first window;
- SDXL ControlNets (``addition_embed_type="text_time"``) take the base
  phase's ``added_cond``.  As in the JAX pipeline the nets run in every
  phase with that phase's conditioning, so a base net beside a refiner
  fails in the refiner phase (its 5 time ids).

img2img, inpainting, progress callbacks, serial CFG, DeepCache, the safety
checker and the adapters come through the inherited methods, as in the JAX
package: the base -> refiner cut splits the strength-sliced plan; a LoRA's
``lora_te2_`` / ``text_encoder_2.`` modules go to CLIP-G; a
textual-inversion embedding needs its ``clip_l`` and ``clip_g`` vectors;
the IP-Adapter tokens reach the base UNet's calls only (the refiner has no
IP projections).
The refiner phase runs inside the same program as the base phase (two
phases, one graph); under ``reduce_memory`` each phase is a stage with its
own UNet (the JAX ``_stage_bundle`` keys "unet" and "refiner"), and the
encode stage takes both text encoders.  ``enable_w8a8`` serves the base
UNet only; the refiner keeps its float layers (the JAX bundle's "int8" key
rides with "unet").
"""

from __future__ import annotations

import numpy as np
import torch

from ..tokenizer.prompt_weights import empty_chunk_row
from .config import PipelineConfiguration
from .sd import TEXT_LEN, StableDiffusionPipeline, _tokenize_chunked


def _to_windows(ids, w, k: int, tokenizer):
    """(B, L) or (B, k', L) ids and weights -> (B, k, L), padded with
    BOS+EOS windows of weight 1."""
    if ids.ndim == 2:
        ids, w = ids[:, None], w[:, None]
    pad = k - ids.shape[1]
    B = ids.shape[0]
    ids = np.concatenate([ids, np.tile(empty_chunk_row(tokenizer, TEXT_LEN), (B, pad, 1))],
                         axis=1)
    w = np.concatenate([w, np.ones((B, pad, TEXT_LEN), np.float32)], axis=1)
    return ids, w


class StableDiffusionXLPipeline(StableDiffusionPipeline):
    default_latent_scale = 0.13025

    def __init__(self, *, tokenizer, tokenizer2, text_encoder=None, text_encoder2, unet,
                 refiner_unet=None, vae_decoder, vae_encoder=None, safety_checker=None,
                 controlnets=(), scheduler_config=None, force_zeros_for_empty_prompt=True,
                 device: str | torch.device = "cuda"):
        # text_encoder (CLIP-L) is optional: refiner-only setups omit it
        super().__init__(tokenizer=tokenizer, text_encoder=text_encoder, unet=unet,
                         vae_decoder=vae_decoder, vae_encoder=vae_encoder,
                         safety_checker=safety_checker, controlnets=controlnets,
                         scheduler_config=scheduler_config, device=device)
        self.tokenizer2 = tokenizer2
        self.text_encoder2 = text_encoder2.to(self.device).eval()
        self.refiner_unet = (None if refiner_unet is None
                             else refiner_unet.to(self.device).eval())
        self.force_zeros_for_empty_prompt = force_zeros_for_empty_prompt

    # -- text ------------------------------------------------------------------

    def _tokenize(self, cfg: PipelineConfiguration) -> dict:
        neg, pos = self._prompt_lists(cfg)
        ids2, w2, any_w2 = _tokenize_chunked(self.tokenizer2, neg + pos)
        out = {}
        if self.text_encoder is not None:
            ids1, w1, any_w1 = _tokenize_chunked(self.tokenizer, neg + pos)
            # the two encoders' states concatenate window by window
            k = max(ids1.shape[1] if ids1.ndim == 3 else 1, ids2.shape[1] if ids2.ndim == 3 else 1)
            if k > 1:
                ids1, w1 = _to_windows(ids1, w1, k, self.tokenizer)
                ids2, w2 = _to_windows(ids2, w2, k, self.tokenizer2)
            out["ids"] = ids1
            if any_w1:
                out["weights"] = w1
        out["ids2"] = ids2
        if any_w2:
            out["weights2"] = w2
        out["zero_negative"] = self.force_zeros_for_empty_prompt and all(t == "" for t in neg)
        out.update(self._time_ids(cfg))
        return out

    @staticmethod
    def _time_ids(cfg: PipelineConfiguration) -> dict:
        """The micro-conditioning rows, float32 host arrays: the base UNet's
        ``[original_size, crops_coords_top_left, target_size]`` for both
        halves, the refiner's ``[original_size, crops_coords_top_left,
        aesthetic_score]`` (the negative score for the negative half)."""
        osz = cfg.original_size or (1024, 1024)
        tsz = cfg.target_size or (1024, 1024)
        crop = cfg.crops_coords_top_left

        def row(*values):
            return np.array([float(v) for v in values], np.float32)

        base = row(osz[0], osz[1], crop[0], crop[1], tsz[0], tsz[1])
        return {"time_ids_unet_neg": base, "time_ids_unet_pos": base.copy(),
                "time_ids_refiner_neg": row(osz[0], osz[1], crop[0], crop[1],
                                            cfg.negative_aesthetic_score),
                "time_ids_refiner_pos": row(osz[0], osz[1], crop[0], crop[1],
                                            cfg.aesthetic_score)}

    def _encode_text(self, token_inputs: dict) -> dict:
        ctx2, out2, shape3 = self._hidden(self.text_encoder2, token_inputs, "ids2",
                                          "penultimate_hidden_state", "weights2")
        pooled = out2["pooled_output"]
        if shape3 is not None:  # the pooled vector of the first window
            pooled = pooled.reshape(shape3[0], shape3[1], -1)[:, 0]
        ctx = ctx2
        if self.text_encoder is not None:
            ctx1, _, _ = self._hidden(self.text_encoder, token_inputs, "ids",
                                      "penultimate_hidden_state", "weights")
            ctx = torch.cat([ctx1, ctx2], dim=-1)
        if token_inputs["zero_negative"]:
            half = ctx.shape[0] // 2  # the negative rows come first
            ctx = torch.cat([ctx[:half] * 0.0, ctx[half:]])
            pooled = torch.cat([pooled[:half] * 0.0, pooled[half:]])
        text = {"context": ctx, "context2": ctx2, "pooled": pooled}
        text.update({k: self._dev(v) for k, v in token_inputs.items()
                     if k.startswith("time_ids")})
        return text

    # -- phases ------------------------------------------------------------------

    def _denoise_phases(self, cfg: PipelineConfiguration, num_steps: int):
        cut = num_steps
        if self.refiner_unet is not None:
            cut = min(num_steps, max(0, int(cfg.refiner_start * num_steps)))
        phases = []
        if cut > 0:
            phases.append((0, cut, "unet"))
        if cut < num_steps:
            phases.append((cut, num_steps, "refiner"))
        return phases

    def _phase_conditioning(self, cfg: PipelineConfiguration, text: dict, N: int,
                            phase: str):
        refiner = phase == "refiner"
        ctx_neg, ctx_pos = self._split_neg_pos(text["context2" if refiner else "context"], N)
        pooled_neg, pooled_pos = self._split_neg_pos(text["pooled"], N)

        def time_ids(half):
            row = text[f"time_ids_{phase}_{half}"]
            return row.expand(N, row.shape[0])

        return (ctx_neg, ctx_pos, {"text_embeds": pooled_neg, "time_ids": time_ids("neg")},
                {"text_embeds": pooled_pos, "time_ids": time_ids("pos")})

    def _phase_unet(self, phase: str):
        return self.refiner_unet if phase == "refiner" else self.unet

    # -- programs and stages -------------------------------------------------------

    def _params_bundle(self) -> dict:
        b = super()._params_bundle()
        b["text_encoder2"] = [self.text_encoder2]
        if self.refiner_unet is not None:
            b["refiner"] = [self.refiner_unet]
        return b

    def _conditioning_cache_key(self, cfg: PipelineConfiguration):
        neg, _ = self._prompt_lists(cfg)
        return (cfg.original_size, cfg.target_size, cfg.crops_coords_top_left,
                cfg.aesthetic_score, cfg.negative_aesthetic_score,
                round(cfg.refiner_start, 4), all(t == "" for t in neg))
