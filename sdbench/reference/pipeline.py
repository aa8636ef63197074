"""The plain reference generation: what a Stable Diffusion txt2img request
should produce, worked out again from the request alone.

- tokens: the letters vocabulary (one token a letter, the word's last letter
  marked ``</w>``), BOS, the letters, EOS, padded with EOS to 77;
- noise: NumPy's legacy ``RandomState(seed)`` standard normals, one stream a
  request, (n, C, h, w) for a request of n images;
- the schedule: DPM-Solver++(2M), data prediction, first order at the first
  step (and at the last below 15 steps), its per-step constants built in
  float64 and held in float32 (Lu et al., arXiv:2211.01095);
- classifier-free guidance at scale g: ``neg + g * (pos - neg)``;
- SDXL: the context is CLIP-L's and bigG's penultimate states side by side,
  the pooled vector bigG's projected EOS state, both zeroed for an empty
  negative prompt, and the time ids (1024, 1024, 0, 0, 1024, 1024);
- the VAE decoder on ``latents / scale``, then ``round(clamp(x / 2 + 1/2) *
  255)`` as uint8.

Everything is held in float32 and runs in groups of images so that it
fits beside nothing else on the card.  The modules that the configuration
states in float32 (the text encoders, the VAE decoder) compute with TF32
off; a denoiser stated in bfloat16 computes its products in TF32, whose
10 mantissa bits still lie well above bfloat16's 7, at a third of the
float32 time.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from . import models, weights

LETTERS = "abcdefghijklmnopqrstuvwxyz"


def letters_vocab(bos: int, eos: int) -> dict[str, int]:
    vocab = {}
    for ch in LETTERS:
        vocab[ch] = len(vocab)
        vocab[ch + "</w>"] = len(vocab)
    vocab["<|startoftext|>"] = bos
    vocab["<|endoftext|>"] = eos
    return vocab


def tokenize(text: str, tok: dict) -> np.ndarray:
    """A prompt of lowercase words -> (max_length,) int64 ids."""
    ids = []
    for word in text.split():
        if not set(word) <= set(LETTERS):
            raise ValueError(f"the letters vocabulary has no token for {word!r}")
        ids += [2 * LETTERS.index(ch) for ch in word[:-1]] + [2 * LETTERS.index(word[-1]) + 1]
    L = tok["max_length"]
    row = [tok["bos"]] + ids[:L - 2] + [tok["eos"]]
    return np.array(row + [tok["pad"]] * (L - len(row)), np.int64)


def noise(seed: int, n: int, shape) -> np.ndarray:
    return np.random.RandomState(seed).standard_normal((n, *shape)).astype(np.float32)


def dpm_tables(sc: dict, steps: int) -> dict:
    """The DPM-Solver++(2M) plan: timesteps and the alpha, sigma and lambda
    of each of the steps + 1 points, float32."""
    T = sc["num_train_timesteps"]
    if sc["beta_schedule"] == "scaledLinear":
        betas = np.linspace(sc["beta_start"] ** 0.5, sc["beta_end"] ** 0.5, T,
                            dtype=np.float64) ** 2
    else:
        betas = np.linspace(sc["beta_start"], sc["beta_end"], T, dtype=np.float64)
    acp = np.cumprod(1.0 - betas)
    ratio_all = np.sqrt((1 - acp) / acp)
    if sc["timestep_spacing"] == "leading":
        ts = (np.arange(steps) * (T // steps)).round()[::-1] + sc["steps_offset"]
    elif sc["timestep_spacing"] == "linspace":
        ts = np.linspace(0, T - 1, steps).round()[::-1]
    else:
        raise ValueError(f"unsupported spacing {sc['timestep_spacing']!r}")
    ts = ts.astype(np.float64)
    ratio = np.concatenate([np.interp(ts, np.arange(T), ratio_all), [ratio_all[0]]])
    alpha = 1.0 / np.sqrt(1.0 + ratio ** 2)
    sigma = ratio * alpha
    return {"timesteps": ts.astype(np.float32), "alpha": alpha.astype(np.float32),
            "sigma": sigma.astype(np.float32),
            "lambda": np.log(alpha / sigma).astype(np.float32),
            "second_order_last": steps >= 15}


def dpm_step(tab: dict, i: int, x, eps, prev_x0):
    """One DPM-Solver++(2M) step -> (next latents, this step's x0)."""
    a, s, lam = tab["alpha"], tab["sigma"], tab["lambda"]
    x0 = (x - float(s[i]) * eps) / float(a[i])
    h = lam[i + 1] - lam[i]
    phi = np.expm1(-h)
    first = float(s[i + 1] / s[i]) * x - float(a[i + 1] * phi) * x0
    last = i == len(tab["timesteps"]) - 1
    if i == 0 or (last and not tab["second_order_last"]):
        return first, x0
    r0 = (lam[i] - lam[i - 1]) / h
    d1 = (x0 - prev_x0) / float(r0)
    return first - float(np.float32(0.5) * a[i + 1] * phi) * d1, x0


@contextlib.contextmanager
def tf32(on: bool):
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


# -- the reference --------------------------------------------------------------

class Reference:
    """The configuration's modules in float32 on ``device``, weights from
    ``seed`` (a module the program holds in bfloat16 holds the same
    bfloat16-rounded values)."""

    def __init__(self, cfg: dict, seed: int, device):
        self.cfg = cfg
        self.device = torch.device(device)
        self.encoders = [self._module("clip", e, seed) for e in cfg["text_encoders"]]
        self.unet = self._module("unet", cfg["unet"], seed)
        self.vae = self._module("vae_decoder", cfg["vae_decoder"], seed)

    def _module(self, kind: str, spec: dict, seed: int):
        with torch.device("meta"):
            m = models.build(kind, spec["config"])
        m = m.to_empty(device=self.device).eval()
        low = getattr(torch, spec["dtype"])
        return weights.fill_(m, seed, spec["role"], round_to=None if low == torch.float32
                             else low)

    @torch.no_grad()
    def text(self, prompts: list[str], negative: str):
        """-> (context (2n, S, C): negatives first, pooled (2n, P) or None)."""
        cfg = self.cfg
        rows = [negative] * len(prompts) + list(prompts)
        ids = torch.from_numpy(np.stack([tokenize(t, cfg["tokenizer"]) for t in rows]))
        ids = ids.to(self.device)
        outs = [enc(ids) for enc in self.encoders]
        ctx = torch.cat([o[e["output"]] for o, e in zip(outs, cfg["text_encoders"])], dim=-1)
        pooled = outs[-1]["pooled_output"] if cfg["family"] == "sdxl" else None
        if cfg["family"] == "sdxl" and negative == "":
            n = len(prompts)
            ctx = torch.cat([ctx[:n] * 0.0, ctx[n:]])
            pooled = torch.cat([pooled[:n] * 0.0, pooled[n:]])
        return ctx, pooled

    @torch.no_grad()
    def denoise(self, prompts: list[str], negative: str, init: np.ndarray) -> torch.Tensor:
        """Initial noise (n, C, h, w) -> the final latents (n, C, h, w)."""
        cfg = self.cfg
        tab = dpm_tables(cfg["scheduler_config"], cfg["step_count"])
        g = float(cfg["guidance_scale"])
        ctx, pooled = self.text(prompts, negative)
        n = len(prompts)
        x = torch.from_numpy(init).to(self.device)
        extra = {}
        if cfg["family"] == "sdxl":
            tid = torch.tensor(cfg["time_ids"], dtype=torch.float32, device=self.device)
            extra = {"text_embeds": pooled, "time_ids": tid.expand(2 * n, tid.shape[0])}
        prev = torch.zeros_like(x)
        for i, t in enumerate(tab["timesteps"]):
            tt = torch.tensor(t, dtype=torch.float32, device=self.device)
            with tf32(self.cfg["unet"]["dtype"] != "float32"):
                out = self.unet(torch.cat([x, x]), tt, ctx, **extra)
            eps = out[:n] + g * (out[n:] - out[:n])
            x, prev = dpm_step(tab, i, x, eps, prev)
        return x

    @torch.no_grad()
    def decode(self, latents_nhwc: np.ndarray) -> np.ndarray:
        """NHWC latents -> (n, H, W, 3) uint8."""
        z = torch.from_numpy(np.ascontiguousarray(latents_nhwc)).to(self.device)
        x = self.vae(z.permute(0, 3, 1, 2) / float(self.cfg["latent_scale"]))
        x = torch.round(torch.clamp(x * 0.5 + 0.5, 0.0, 1.0) * 255.0).to(torch.uint8)
        return x.permute(0, 2, 3, 1).cpu().numpy()
