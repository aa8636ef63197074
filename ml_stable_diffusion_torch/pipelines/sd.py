"""Stable Diffusion 1.x/2.x pipeline: txt2img, img2img and inpainting
(port of ml_stable_diffusion_tpu/pipelines/sd.py).

The JAX package compiles the whole generation into one XLA program; here
the same steps run eagerly on the card:

1. tokenize the negative and positive prompts, encode them with CLIP;
2. draw the initial noise on the host (numpy, torch or Philox streams, NCHW
   then NHWC, as the JAX package does) and scale it by ``init_noise_sigma``.
   A scheduler that needs noise at every step (Euler ancestral, LCM) takes
   one more draw of the same stream a step, or of each image's own stream
   for a list of seeds;
3. img2img (``starting_image``): encode the image once with the VAE
   encoder, ``z0 = sample_diagonal_gaussian(moments, noise) * scale`` with
   the same host draw as the noise, and start from ``add_noise(plan, z0,
   noise)`` on the strength-sliced plan;
4. each step: ``scale_model_input``, the UNet on ``cat([lat, lat])`` with
   ``cat([ctx_neg, ctx_pos])``, the guidance ``neg + g * (pos - neg)``, the
   scheduler step.  Inpainting (``mask_image``, 1 = repaint): the pixel mask
   area-pooled to the latents; a 4-channel UNet has the known region
   replaced after every step by ``z0`` re-noised to the next step's level
   (clean after the last); a 9-channel inpainting UNet takes ``[latents,
   mask, masked-image latents]`` as its input instead.  A guidance-embedded
   (LCM) UNet runs without CFG and takes ``w = guidance_scale - 1`` as its
   ``timestep_cond``;
5. decode with the VAE to uint8 pixels.

``seconds_per_step`` is measured as in the JAX package: text encoding plus
the denoise loop, ended by fetching the latents to the host, divided by the
step count.  Images come back as one (N, H, W, 3) uint8 array
(``utils.image.to_pil`` converts).  Features not ported yet raise
``NotImplementedError`` naming their ROADMAP.md item.

Palettized weights (``install_palettized``) are served as the JAX package
serves them: dequantized once on the host (``mode="install"``), or kept on
the card as uint8 indices and float32 LUTs and gathered into the module's
parameters at the start of each ``generate_images`` call, inside its timed
window, and freed at its end (``mode="program"``).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..compress.palettize import PalettizedTensor
from ..ops.attention import set_attention_implementation
from ..schedulers import SCHEDULER_MAP
from ..models.unet import get_guidance_scale_embedding
from ..models.vae import sample_diagonal_gaussian
from ..schedulers.base import Scheduler, SchedulerConfig, TimestepSpacing
from ..utils.image import nchw_to_nhwc, pil_to_tensor
from ..utils.numerics import apply_numerics
from ..utils.rng import make_random_source
from .config import PipelineConfiguration

TEXT_LEN = 77

#: prompt-weight syntax the JAX package parses (tokenizer/prompt_weights.py)
_WEIGHT_SYNTAX = set("()[]\\")


@dataclasses.dataclass
class GenerationResult:
    images: np.ndarray  # (N, H, W, 3) uint8
    latents: np.ndarray  # (N, h, w, C) float32, NHWC as in the JAX package
    nsfw_flags: list[bool]
    seconds_per_step: float


#: configuration fields of features not ported yet, with the ROADMAP item
#: that brings them: a value other than the default raises rather than being
#: ignored.  The SDXL-only fields (``refiner_start`` and the
#: micro-conditioning) and ``timestep_shift`` are not here: the JAX SD and
#: SD3 pipelines ignore the first, and every scheduler but DiscreteFlow the
#: second, and so does the port
_UNPORTED_FIELDS = {
    "controlnet_inputs": "ControlNet: ROADMAP Queue 1 item 12",
    "deepcache_interval": "DeepCache: ROADMAP Queue 1 item 12",
    "unet_batch_one": "serial batch-1 CFG: ROADMAP Queue 1 item 12",
    "use_denoised_intermediates": "denoised previews (progress callbacks): ROADMAP Queue 1 item 12",
    "ip_adapter_image": "IP-Adapter: ROADMAP Queue 1 item 15",
    "ip_adapter_scale": "IP-Adapter: ROADMAP Queue 1 item 15",
    "reduce_memory": "reduce_memory staging: ROADMAP Queue 1 item 17",
}


def _unported(cfg: PipelineConfiguration):
    """Raise for a field of an unported feature set away from its default."""
    defaults = PipelineConfiguration()
    for name, what in _UNPORTED_FIELDS.items():
        value, default = getattr(cfg, name), getattr(defaults, name)
        if isinstance(default, tuple):
            value = tuple(value)
        if value is not None if default is None else value != default:
            raise NotImplementedError(f"{what} ({name}={value!r}) is not ported yet")


def _mask_pixels(mask, N: int, H: int, W: int) -> np.ndarray:
    """A repaint mask (PIL image or array: (H, W), (H, W, 1|3), (N, H, W) or
    (N, H, W, 1|3)) -> (N, H, W, 1) float32 in [0, 1], as the JAX pipeline
    reads it."""
    if not isinstance(mask, np.ndarray):
        mask = pil_to_tensor(mask, size=(H, W), value_range=(0.0, 1.0))
    m = np.asarray(mask, np.float32)
    if m.ndim == 2:
        m = m[None, :, :, None]
    elif m.ndim == 3:
        m = m[None] if m.shape[-1] in (1, 3) else m[..., None]
    if m.shape[-1] == 3:
        m = m.mean(axis=-1, keepdims=True)
    return np.broadcast_to(np.clip(m, 0.0, 1.0), (N, H, W, 1)).copy()


class StableDiffusionPipeline:
    """SD 1.x / 2.x: txt2img, img2img and inpainting.

    Model arguments are ``nn.Module``s (``CLIPTextEncoder``,
    ``UNet2DConditionModel``, ``VAEDecoder``, and ``VAEEncoder`` for img2img
    and inpainting) in the dtypes they should compute in; they are moved to
    ``device``.
    """

    default_latent_scale = 0.18215
    default_latent_shift = 0.0
    latent_channels = 4
    vae_downscale = 8
    #: whether DeepCache's shallow/deep split applies to this denoiser (the
    #: JAX pipelines' flag; the MMDiT has no such split)
    supports_deepcache = True

    def __init__(self, *, tokenizer, text_encoder, unet, vae_decoder,
                 vae_encoder=None, safety_checker=None, controlnets=(),
                 scheduler_config: SchedulerConfig | None = None,
                 text_embedding_key: str = "last_hidden_state",
                 device: str | torch.device = "cuda"):
        if safety_checker is not None:
            raise NotImplementedError("the safety checker: ROADMAP Queue 1 item 12")
        if controlnets:
            raise NotImplementedError("ControlNet: ROADMAP Queue 1 item 12")
        apply_numerics()
        self.device = torch.device(device)
        self.tokenizer = tokenizer
        self.text_encoder = (None if text_encoder is None
                             else text_encoder.to(self.device).eval())
        self.unet = unet.to(self.device).eval()
        self.vae_decoder = vae_decoder.to(self.device).eval()
        self.vae_encoder = (None if vae_encoder is None
                            else vae_encoder.to(self.device).eval())
        self.scheduler_config = scheduler_config or SchedulerConfig()
        self.text_embedding_key = text_embedding_key
        #: program mode: module key -> ({parameter key: PalettizedTensor on
        #: the device}, install dtype)
        self.palettized_side: dict[str, tuple[dict[str, PalettizedTensor], torch.dtype]] = {}

    # -- compressed serving ------------------------------------------------------

    #: install_palettized's module keys -> the pipeline attribute that holds
    #: the module (the JAX package's _PALETTIZED_ATTRS, for the port's modules)
    _PALETTIZED_ATTRS = {
        "unet": "unet",
        "refiner": "refiner_unet",
        "text_encoder": "text_encoder",
        "text_encoder2": "text_encoder2",
    }

    def install_palettized(self, module_key: str, tree: dict, dtype=None, mode: str = "install"):
        """Serve ``module_key`` ('unet', 'refiner', ...) from ``tree``, its
        state dict with ``PalettizedTensor`` entries (compress/palettize.py).

        ``mode="install"``: dequantize once on the host, round every entry
        through ``dtype`` (default: the denoiser's dtype) and load the result
        into the module, which keeps its own compute dtype: a float32 CLIP
        installed at bf16 holds bf16-rounded values.
        ``mode="program"``: keep the uint8 indices and float32 LUTs on the
        device; ``generate_images`` gathers them into the module's
        parameters (through ``dtype``) at the start of each call and frees
        them at its end, so dense copies of those weights do not stay on the
        device between generations.  The rest of the state dict is loaded
        now."""
        attr = self._PALETTIZED_ATTRS[module_key]
        module = getattr(self, attr)
        dtype = dtype if dtype is not None else next(self.unet.parameters()).dtype
        if module_key in self.palettized_side:
            # a module served in program mode before: its parameters get
            # their shapes back before they are loaded anew
            self._materialize_palettized()
            del self.palettized_side[module_key]
            self._release_palettized()
        with torch.no_grad():
            if mode == "install":
                module.load_state_dict(
                    {k: (v.dequantize() if isinstance(v, PalettizedTensor) else v).to(dtype)
                     for k, v in tree.items()}, strict=True)
            elif mode == "program":
                pal = {k: v for k, v in tree.items() if isinstance(v, PalettizedTensor)}
                missing, unexpected = module.load_state_dict(
                    {k: v for k, v in tree.items() if k not in pal}, strict=False)
                if unexpected or set(missing) != set(pal):
                    raise KeyError(f"{module_key}: the tree does not match the module: missing "
                                   f"{sorted(set(missing) - set(pal))}, unexpected {unexpected}")
                dev = next(module.parameters()).device
                self.palettized_side[module_key] = (
                    {k: v.to(dev) for k, v in pal.items()}, dtype)
                self._release_palettized()
            else:
                raise ValueError(f"unknown mode {mode!r}")

    @torch.no_grad()
    def _materialize_palettized(self):
        """Program mode: gather each LUT into its parameter, rounded through
        the install dtype, held in the parameter's dtype."""
        for mk, (pal, dtype) in self.palettized_side.items():
            module = getattr(self, self._PALETTIZED_ATTRS[mk])
            for key, pt in pal.items():
                p = module.get_parameter(key)
                p.data = pt.dequantize().to(dtype).to(p.dtype)

    def _release_palettized(self):
        """Program mode: free the dense copies (empty parameters)."""
        for mk, (pal, _) in self.palettized_side.items():
            module = getattr(self, self._PALETTIZED_ATTRS[mk])
            for key in pal:
                p = module.get_parameter(key)
                p.data = torch.empty(0, dtype=p.dtype, device=p.device)

    # -- scheduler -------------------------------------------------------------

    def _scheduler_name(self, cfg: PipelineConfiguration) -> str:
        """The scheduler this family runs for ``cfg.scheduler``."""
        return cfg.scheduler

    def _make_scheduler(self, cfg: PipelineConfiguration) -> Scheduler:
        name = self._scheduler_name(cfg)
        if name not in SCHEDULER_MAP:
            raise ValueError(f"unknown scheduler {name!r}; expected one of "
                             f"{sorted(SCHEDULER_MAP)}")
        cls = SCHEDULER_MAP[name]
        kwargs = {}
        if cfg.timestep_spacing is not None:
            kwargs["timestep_spacing"] = TimestepSpacing(cfg.timestep_spacing)
        if name == "DiscreteFlow":
            kwargs["shift"] = cfg.timestep_shift
        return cls(self.scheduler_config, **kwargs)

    # -- text ------------------------------------------------------------------

    @staticmethod
    def _prompt_lists(cfg: PipelineConfiguration):
        """-> (negatives, positives) as equal-length lists; a multi-prompt
        batch encodes rows [neg_0..neg_{N-1}, pos_0..pos_{N-1}]."""
        multi = isinstance(cfg.prompt, (list, tuple))
        pos = list(cfg.prompt) if multi else [cfg.prompt]
        if isinstance(cfg.negative_prompt, (list, tuple)):
            neg = list(cfg.negative_prompt)
        else:
            neg = [cfg.negative_prompt] * len(pos)
        if multi and len(pos) != cfg.image_count:
            raise ValueError(
                f"prompt list length {len(pos)} != image_count {cfg.image_count}")
        if len(neg) != len(pos):
            raise ValueError("negative_prompt list length must match prompt")
        return neg, pos

    @staticmethod
    def _token_rows(tokenizer, texts) -> np.ndarray:
        """(len(texts), 77) int32 ids; prompt weights and prompts longer
        than one window raise."""
        rows = []
        for text in texts:
            if _WEIGHT_SYNTAX & set(text):
                raise NotImplementedError(
                    f"prompt weight syntax in {text!r}: ROADMAP Queue 1 item 12")
            if len(tokenizer.encode(text)) > TEXT_LEN - 2:
                raise NotImplementedError(
                    "prompts longer than one 77-token window: ROADMAP Queue 1 item 12")
            rows.append(tokenizer.tokenize(text, TEXT_LEN)[0])
        return np.stack(rows)

    def _tokenize(self, cfg: PipelineConfiguration) -> dict:
        """-> {"ids": (2N or 2, 77) int32}, negatives first."""
        neg, pos = self._prompt_lists(cfg)
        return {"ids": self._token_rows(self.tokenizer, neg + pos)}

    def _ids(self, token_inputs: dict, key: str) -> torch.Tensor:
        return torch.from_numpy(token_inputs[key]).long().to(self.device)

    def _encode_text(self, token_inputs: dict) -> dict:
        """-> {"context": (2N or 2, 77, C), ...}: what the denoiser is
        conditioned on (SD3 adds the pooled vector)."""
        return {"context": self.text_encoder(self._ids(token_inputs, "ids"))[
            self.text_embedding_key]}

    @staticmethod
    def _split_neg_pos(t, N: int):
        """(2, ...) single-prompt rows broadcast to N images; (2N, ...)
        multi-prompt rows split into contiguous halves."""
        if t.shape[0] == 2 and N != 1:
            return t[0:1].expand(N, *t.shape[1:]), t[1:2].expand(N, *t.shape[1:])
        half = t.shape[0] // 2
        return t[:half], t[half:]

    # -- denoiser phases (SDXL adds the refiner's) -------------------------------

    def _denoise_phases(self, cfg: PipelineConfiguration, num_steps: int):
        """-> [(start, end, phase)]: the step ranges and the denoiser of each
        ("unet"; SDXL's refiner is "refiner").  One phase here."""
        return [(0, num_steps, "unet")]

    def _phase_conditioning(self, cfg: PipelineConfiguration, text: dict, N: int,
                            phase: str):
        """-> (ctx_neg, ctx_pos, added_neg, added_pos) of ``phase``: the text
        conditioning split into its negative and positive halves; ``added``
        holds what the denoiser takes beside the context (None here)."""
        ctx_neg, ctx_pos = self._split_neg_pos(text["context"], N)
        return ctx_neg, ctx_pos, None, None

    def _call_unet(self, phase: str, latents, t, context, added_cond, timestep_cond=None):
        return self.unet(latents, t, context, timestep_cond=timestep_cond)

    # -- latents ---------------------------------------------------------------

    def _noise(self, cfg: PipelineConfiguration, N: int, h: int, w: int, step_draws: int):
        """Host noise, NHWC float32: the initial draw (N, h, w, C) and, for a
        scheduler that needs noise, ``step_draws`` more (step_draws, N, h, w,
        C) continuing the stream, else None.  One stream for the batch, or
        each image's own seed stream for a list of seeds."""
        C = self.latent_channels
        if isinstance(cfg.seed, (list, tuple)):
            if len(cfg.seed) != N:
                raise ValueError(f"seed list length {len(cfg.seed)} != image_count {N}")
            srcs = [make_random_source(cfg.rng, s) for s in cfg.seed]

            def draw():
                return np.concatenate([nchw_to_nhwc(src.normal((1, C, h, w))) for src in srcs])
        else:
            src = make_random_source(cfg.rng, cfg.seed)

            def draw():
                return nchw_to_nhwc(src.normal((N, C, h, w)))
        init = draw().astype(np.float32)
        steps = (np.stack([draw() for _ in range(step_draws)]).astype(np.float32)
                 if step_draws else None)
        return init, steps

    def _nchw(self, x: np.ndarray) -> torch.Tensor:
        """An NHWC host array -> a contiguous NCHW float32 tensor on the device."""
        return torch.from_numpy(np.array(x, np.float32)).to(self.device).permute(
            0, 3, 1, 2).contiguous()

    def _start(self, cfg, plan, scheduler, noise, N: int, hw, img2img: bool, inpaint: bool,
               unet9: bool):
        """-> (latents, inpainting state): the first latents (NCHW) and, for
        inpainting, {"mask": latent mask, and "extras9" (9-channel UNet) or
        "z0" and "noise" (4-channel)}, as the JAX encode stage builds them."""
        noise = self._nchw(noise)
        if not img2img:
            return noise * plan.init_noise_sigma, None
        if self.vae_encoder is None:
            raise ValueError("starting_image needs a pipeline with a vae_encoder")
        h, w = hw
        ds = self.vae_downscale
        H, W = h * ds, w * ds
        image = cfg.starting_image
        if not isinstance(image, np.ndarray):
            image = pil_to_tensor(image, size=(H, W))
        image = self._nchw(np.broadcast_to(image, (N, H, W, 3)))
        scale = cfg.encoder_scale_factor or self.default_latent_scale
        # the parity RNG modes use the single host draw for the encoder too
        z0 = sample_diagonal_gaussian(self.vae_encoder(image), noise) * scale
        latents = scheduler.add_noise(plan, z0, noise)
        if not inpaint:
            return latents, None
        mask_px = self._nchw(_mask_pixels(cfg.mask_image, N, H, W))
        # latent-resolution mask by area pooling of the pixel mask
        mask = mask_px.reshape(N, 1, h, ds, w, ds).mean(dim=(3, 5))
        if unet9:
            masked = image * (1.0 - mask_px)
            masked_z0 = sample_diagonal_gaussian(self.vae_encoder(masked), noise) * scale
            return latents, {"mask": mask, "extras9": torch.cat([mask, masked_z0], dim=1)}
        return latents, {"mask": mask, "z0": z0, "noise": noise}

    def _denoise(self, cfg, latents, text, N, plan, scheduler, guidance_on, g,
                 step_noises=None, inpaint=None, timestep_cond=None):
        """The denoise loop on NCHW float32 latents: the phases in turn over
        one scheduler state, as the JAX package's consecutive scans.
        ``step_noises`` (steps, N, h, w, C) host noise for a scheduler that
        needs it; ``inpaint`` the inpainting state of ``_start``;
        ``timestep_cond`` the guidance embedding of a guidance-embedded UNet
        (its base phase only)."""
        timesteps = torch.from_numpy(plan.timesteps).to(self.device)
        state = scheduler.initial_state(plan, latents)
        inpaint = inpaint or {}
        for start, end, phase in self._denoise_phases(cfg, plan.num_steps):
            ctx_neg, ctx_pos, added_neg, added_pos = self._phase_conditioning(
                cfg, text, N, phase)
            base = phase == "unet"
            # 9-channel inputs and the guidance embedding reach the base UNet
            # only (the SDXL refiner has neither)
            extras9 = inpaint.get("extras9") if base else None
            tc_kw = {"timestep_cond": timestep_cond} if base and timestep_cond is not None else {}
            ctx2 = added2 = None
            if guidance_on:
                ctx2 = torch.cat([ctx_neg, ctx_pos])
                if added_pos is not None:
                    added2 = {key: torch.cat([added_neg[key], added_pos[key]])
                              for key in added_pos}
            for i in range(start, end):
                t = timesteps[i]
                lat_in = scheduler.scale_model_input(plan, state, latents, i)
                if extras9 is not None:
                    lat_in = torch.cat([lat_in, extras9.to(lat_in.dtype)], dim=1)
                if guidance_on:
                    out = self._call_unet(phase, torch.cat([lat_in, lat_in]), t, ctx2, added2)
                    out_neg, out_pos = out.chunk(2)
                    noise_pred = out_neg + g * (out_pos - out_neg)
                else:
                    noise_pred = self._call_unet(phase, lat_in, t, ctx_pos, added_pos, **tc_kw)
                noise = None
                if scheduler.needs_noise:
                    noise = self._nchw(step_noises[i])
                state, latents = scheduler.step(plan, state, noise_pred, i, latents, noise=noise)
                if "z0" in inpaint:
                    # the known region at the next step's noise level
                    z0, m = inpaint["z0"], inpaint["mask"]
                    known = (z0 if i + 1 >= plan.num_steps else
                             scheduler.add_noise(plan, z0, inpaint["noise"], i + 1))
                    latents = m * latents + (1.0 - m) * known
        return latents

    # -- decode ----------------------------------------------------------------

    @torch.inference_mode()
    def decode_latents(self, latents: np.ndarray,
                       cfg: PipelineConfiguration | None = None) -> np.ndarray:
        """Scaled NHWC latents -> (N, H, W, 3) uint8 images."""
        scale = ((cfg.decoder_scale_factor if cfg else None)
                 or self.default_latent_scale)
        shift = ((cfg.decoder_shift_factor if cfg else None)
                 or self.default_latent_shift)
        z = torch.from_numpy(np.ascontiguousarray(latents)).to(self.device)
        x = self.vae_decoder(z.permute(0, 3, 1, 2) / scale + shift)
        x = torch.clamp(x * 0.5 + 0.5, 0.0, 1.0)
        pixels = torch.round(x * 255.0).to(torch.uint8)
        return pixels.permute(0, 2, 3, 1).cpu().numpy()

    # -- public API ----------------------------------------------------------------

    def generate_images(self, cfg: PipelineConfiguration, progress_handler=None,
                        image_hw: tuple[int, int] = (512, 512)) -> GenerationResult:
        cfg.validate()
        if cfg.deepcache_interval > 1 and not self.supports_deepcache:
            raise ValueError("deepcache_interval > 1 is not supported for this model family "
                             "(no shallow/deep UNet split)")
        _unported(cfg)
        if progress_handler is not None:
            raise NotImplementedError("progress callbacks: ROADMAP Queue 1 item 12")
        N = cfg.image_count
        h, w = image_hw[0] // self.vae_downscale, image_hw[1] // self.vae_downscale
        scheduler = self._make_scheduler(cfg)
        img2img = cfg.starting_image is not None
        inpaint = cfg.mask_image is not None
        C = self.latent_channels
        unet9 = self.unet.config.in_channels == C + 5
        if inpaint and not img2img:
            raise ValueError("mask_image requires starting_image")
        if unet9 and not inpaint:
            raise ValueError("this checkpoint is a 9-channel inpainting UNet; pass "
                             "starting_image + mask_image")
        plan = scheduler.set_timesteps(cfg.step_count,
                                       strength=cfg.strength if img2img else 1.0)
        # a guidance-embedded (LCM) UNet never runs CFG: the scale is an input
        tcp = getattr(self.unet.config, "time_cond_proj_dim", None)
        guidance_on = cfg.guidance_scale > 1.0 and not tcp
        set_attention_implementation(cfg.attention_implementation)

        token_inputs = self._tokenize(cfg)
        noise, step_noises = self._noise(cfg, N, h, w,
                                         plan.num_steps if scheduler.needs_noise else 0)

        t0 = time.perf_counter()
        self._materialize_palettized()
        try:
            with torch.inference_mode():
                text = self._encode_text(token_inputs)
                w_emb = None
                if tcp:
                    w_emb = get_guidance_scale_embedding(
                        torch.full((N,), float(cfg.guidance_scale) - 1.0,
                                   dtype=torch.float32, device=self.device), tcp)
                latents, inpaint_state = self._start(cfg, plan, scheduler, noise, N, (h, w),
                                                     img2img, inpaint, unet9)
                latents = self._denoise(cfg, latents, text, N, plan, scheduler, guidance_on,
                                        float(cfg.guidance_scale), step_noises,
                                        inpaint_state, w_emb)
                # the host fetch waits for the device
                latents = latents.permute(0, 2, 3, 1).cpu().numpy()
        finally:
            self._release_palettized()
        dt = (time.perf_counter() - t0) / plan.num_steps

        images = self.decode_latents(latents, cfg)
        return GenerationResult(images=images, latents=latents,
                                nsfw_flags=[False] * N, seconds_per_step=dt)
