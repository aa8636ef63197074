"""The plain reference generation of the SD3 family (SD3 / SD3.5): what a
txt2img request should produce, worked out again from the request alone.

- tokens: CLIP's letters vocabulary (``pipeline.tokenize``) for both CLIP
  encoders; for T5 the letters vocabulary of ``t5_tokenize``: a word's
  first letter ``29 + i`` (the sentencepiece word start), every other
  letter ``3 + i``, then EOS 1, padded with 0 to the configured length,
  the mask over the letters and EOS;
- the context: CLIP-L's and bigG's penultimate states side by side (768 +
  1280), zero-padded to the MMDiT's ``context_dim``, then T5's final
  states: (2n, 77 + 77, 4096); the pooled vector CLIP-L's and bigG's
  pooled outputs side by side (768 + 1280);
- noise: NumPy's legacy ``RandomState(seed)`` standard normals, one stream a
  request, (n, 16, h, w);
- the schedule: rectified flow with the configured shift s, sigmas
  ``s t / (1 + (s - 1) t)`` at ``t = linspace(1, 1/S, S)`` then 0, built in
  float64 and held in float32; the timestep ``sigma * 1000`` (in float64,
  then float32); the Euler step ``x + (sigma_next - sigma) v``, the
  difference taken in float32;
- classifier-free guidance at scale g: ``neg + g * (pos - neg)``, the
  negative rows first in one batch;
- the VAE decoder on ``latents / scale + shift``, then ``round(clamp(x / 2 +
  1/2) * 255)`` as uint8.

Where the program departs from the published pipeline the reference
follows it: CLIP-L's pooled output is its final state at EOS without
``text_projection`` (the program builds CLIP-L unprojected); an empty
negative prompt is encoded as any other prompt (diffusers' SD3 does the
same; SDXL's zeroing does not apply); T5 sees the attention mask and 77
positions (Stability's reference inference pads T5 to 77; diffusers
defaults to 256 and passes no mask).

Everything is held in float32 and runs in groups of images.  The CLIP
encoders and the VAE decoder, stated in float32, compute with TF32 off;
the MMDiT and T5, stated in bfloat16, compute their products in TF32 (10
mantissa bits, well above bfloat16's 7).  A module stated in bfloat16 holds
the bfloat16-rounded values of its weights, except T5's relative-position
table, which the program keeps in float32.
"""

from __future__ import annotations

import numpy as np
import torch

from . import mmdit, weights
from .pipeline import LETTERS, tf32, tokenize

#: T5's ids of a word's first letter and of the others
T5_WORD_START, T5_LETTER = 29, 3
#: the parameter a bfloat16 T5 keeps in float32
T5_F32 = "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"


def t5_tokenize(text: str, tok: dict) -> tuple[np.ndarray, np.ndarray]:
    """A prompt of lowercase words -> (ids, mask), each (max_length,) int32."""
    ids = []
    for word in text.split():
        if not set(word) <= set(LETTERS):
            raise ValueError(f"the letters vocabulary has no token for {word!r}")
        ids += [T5_WORD_START + LETTERS.index(word[0])] + [T5_LETTER + LETTERS.index(ch)
                                                           for ch in word[1:]]
    L = tok["max_length"]
    row = ids[:L - 1] + [tok["eos"]]
    pad = L - len(row)
    return (np.array(row + [tok["pad"]] * pad, np.int32),
            np.array([1] * len(row) + [0] * pad, np.int32))


def flow_plan(steps: int, shift: float) -> tuple[np.ndarray, np.ndarray]:
    """(timesteps, sigmas) of the shifted flow schedule: the steps
    timesteps ``sigma * 1000`` and the steps + 1 sigmas, each computed in
    float64 and held in float32."""
    t = np.linspace(1.0, 1.0 / steps, steps)
    s = np.concatenate([shift * t / (1.0 + (shift - 1.0) * t), [0.0]])
    return (s[:-1] * 1000.0).astype(np.float32), s.astype(np.float32)


def fill(module: torch.nn.Module, seed: int, spec: dict):
    """``module`` (float32, on its device) with the weights of ``spec``'s
    role: bfloat16-rounded where the program holds bfloat16 (T5's table
    excepted), the positional table of an MMDiT scaled as the program's."""
    low = getattr(torch, spec["dtype"])
    weights.fill_(module, seed, spec["role"])
    if low != torch.float32:
        with torch.no_grad():
            for name, p in module.named_parameters():
                if name != T5_F32:
                    p.copy_(p.to(low))
    if isinstance(module, mmdit.MMDiTX):
        mmdit.scale_positions_(module, low)
    return module


class Reference:
    """The configuration's modules in float32 on ``device``, weights from
    ``seed``."""

    def __init__(self, cfg: dict, seed: int, device):
        self.cfg = cfg
        self.device = torch.device(device)
        self.encoders = [self._module("clip", e, seed) for e in cfg["text_encoders"]]
        self.t5 = self._module("t5", cfg["t5"], seed)
        self.mmdit = self._module("mmdit", cfg["mmdit"], seed)
        self.vae = self._module("vae_decoder", cfg["vae_decoder"], seed)

    def _module(self, kind: str, spec: dict, seed: int):
        with torch.device("meta"):
            m = mmdit.build(kind, spec["config"])
        return fill(m.to_empty(device=self.device).eval(), seed, spec)

    @torch.no_grad()
    def text(self, prompts: list[str], negative: str):
        """-> (context (2n, 77 + L, context_dim), pooled (2n, 2048)),
        negatives first."""
        cfg = self.cfg
        rows = [negative] * len(prompts) + list(prompts)
        ids = torch.from_numpy(np.stack([tokenize(t, cfg["tokenizer"]) for t in rows]))
        outs = [enc(ids.to(self.device)) for enc in self.encoders]
        clip = torch.cat([o["penultimate_hidden_state"] for o in outs], dim=-1)
        width = cfg["mmdit"]["config"]["context_dim"]
        clip = torch.nn.functional.pad(clip, (0, width - clip.shape[-1]))
        t5 = [t5_tokenize(t, cfg["t5_tokenizer"]) for t in rows]
        t5_ids, t5_mask = (torch.from_numpy(np.stack(x)).long().to(self.device)
                           for x in zip(*t5))
        with tf32(cfg["t5"]["dtype"] != "float32"):
            states = self.t5(t5_ids, t5_mask)["encoder_hidden_states"]
        pooled = torch.cat([o["pooled_output"] for o in outs], dim=-1)
        return torch.cat([clip, states], dim=1), pooled

    @torch.no_grad()
    def denoise(self, prompts: list[str], negative: str, init: np.ndarray) -> torch.Tensor:
        """Initial noise (n, C, h, w) -> the final latents (n, C, h, w)."""
        cfg = self.cfg
        timesteps, sigmas = flow_plan(cfg["step_count"], cfg["timestep_shift"])
        g = float(cfg["guidance_scale"])
        ctx, pooled = self.text(prompts, negative)
        n = len(prompts)
        x = torch.from_numpy(init).to(self.device)
        for i in range(cfg["step_count"]):
            t = torch.tensor(timesteps[i], device=self.device)
            with tf32(cfg["mmdit"]["dtype"] != "float32"):
                v = self.mmdit(torch.cat([x, x]), t, ctx, pooled)
            v = v[:n] + g * (v[n:] - v[:n])
            x = x + float(sigmas[i + 1] - sigmas[i]) * v
        return x

    @torch.no_grad()
    def decode(self, latents_nhwc: np.ndarray) -> np.ndarray:
        """NHWC latents -> (n, H, W, 3) uint8."""
        z = torch.from_numpy(np.ascontiguousarray(latents_nhwc)).to(self.device)
        z = z.permute(0, 3, 1, 2) / float(self.cfg["latent_scale"]) + float(
            self.cfg["latent_shift"])
        x = self.vae(z)
        x = torch.round(torch.clamp(x * 0.5 + 0.5, 0.0, 1.0) * 255.0).to(torch.uint8)
        return x.permute(0, 2, 3, 1).cpu().numpy()
