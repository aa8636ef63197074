"""Stable Diffusion 1.x/2.x pipeline: txt2img, img2img and inpainting
(port of ml_stable_diffusion_tpu/pipelines/sd.py).

The JAX package compiles the whole generation into one XLA program per
configuration; here it is one captured CUDA graph per program key
(``pipelines/program.py``), replayed from static input buffers.  The host
prepares every input (token ids, prompt weights, noise, images, masks,
timesteps) and the body runs these steps on the card:

1. tokenize the negative and positive prompts, with the prompt-weight
   syntax (``tokenizer/prompt_weights.py``) and windows of 75 tokens for
   longer prompts (up to 4; the windows' hidden states are concatenated
   along the sequence), and encode them with CLIP; weighted tokens scale
   their hidden states, the mean of each prompt's kept
   (``apply_prompt_weights``).  A ``multilingual_encoder=(projection,
   embed_fn)`` takes the text encoder's place: the host ``embed_fn``'s
   rows, cut or zero-padded to 256, through the projection;
2. draw the initial noise on the host (numpy, torch or Philox streams, NCHW
   then NHWC, as the JAX package does) and scale it by ``init_noise_sigma``.
   A scheduler that needs noise at every step (Euler ancestral, LCM) takes
   one more draw of the same stream a step, or of each image's own stream
   for a list of seeds;
3. img2img (``starting_image``): encode the image once with the VAE
   encoder, ``z0 = sample_diagonal_gaussian(moments, noise) * scale`` with
   the same host draw as the noise, and start from ``add_noise(plan, z0,
   noise)`` on the strength-sliced plan;
4. each step: ``scale_model_input``; the ControlNets (one per
   ``controlnet_inputs`` image) on those latents with the positive context,
   their residuals summed in order; the UNet on ``cat([lat, lat])`` with
   ``cat([ctx_neg, ctx_pos])`` and the residuals ``[r, r]`` (or, with
   ``unet_batch_one``, two calls of batch N), the guidance ``neg + g * (pos -
   neg)``, the scheduler step.  DeepCache (``deepcache_interval`` dc > 1):
   step i of a phase starting at step lo runs the full UNet iff (i - lo) %
   dc == 0, and the shallow pass on the cached deep feature otherwise.
   Inpainting (``mask_image``, 1 = repaint): the pixel mask area-pooled to
   the latents; a 4-channel UNet has the known region replaced after every
   step by ``z0`` re-noised to the next step's level (clean after the
   last); a 9-channel inpainting UNet takes ``[latents, mask, masked-image
   latents]`` as its input instead (its ControlNets see the 4 channels).  A
   guidance-embedded (LCM) UNet runs without CFG and takes ``w =
   guidance_scale - 1`` as its ``timestep_cond``.  A ``progress_handler``
   gets a ``PipelineProgress`` after every step and stops the loop by
   returning False;
5. decode with the VAE to uint8 pixels; the safety checker, if any and not
   ``disable_safety``, zeroes the images it flags.

Adapters, as in the JAX package: ``apply_lora`` merges LoRA adapters into
the weights (stacking; ``clear_loras`` restores them bit for bit),
``load_textual_inversion`` grows the CLIP token tables and registers the
placeholder with the tokenizers, and ``load_ip_adapter`` gives the UNet's
cross attentions the decoupled IP-Adapter projections.  With an
``ip_adapter_image`` the CLIP vision encoder and the adapter's projection
make the image tokens once per generation (BASE: the projected image
embedding, the negative branch from zeros; PLUS: the resampled penultimate
patch states, the negative branch from an image at the CLIP mean); every
call of the base UNet takes them, scaled by ``ip_adapter_scale``, and no
ControlNet does.

How a generation runs, as the JAX ``generate_images`` dispatches:

- the default: one program (the JAX ``prog["full"]``).  On the card it is
  captured once per key, at its first call, and replayed; the decode is a
  program of its own per (N, h, w) (the JAX ``_decode_fn``).  The safety
  checker stays eager;
- with a ``progress_handler``: the eager per-step loop (the JAX
  per-step programs ``prog["steps"]``), the handler after each step;
- ``reduce_memory``: the staged path (the JAX ``prog["init"]`` and
  ``prog["phase_scans"]``).  The encode stage, each denoise phase, the
  decode and the checker each get only their modules' weights
  (``_stage_bundle``); after ``offload_params_to_host`` those weights wait
  in pinned host memory and move to the card for their stage and leave it
  after, and a module served palettized in program mode is gathered in its
  own stage only (the JAX stage bundle's ``palettized`` side).  The stages
  run eagerly: their weights land at new addresses on every call;
- ``execution = "eager"`` (a pipeline attribute, not a configuration
  field): the same body, launched op by op from the host; so do a pipeline
  whose weights were offloaded and a palettized pipeline in program mode,
  which rebinds its parameters on every call.

``seconds_per_step`` is measured as in the JAX package: text encoding (and
the image tokens) plus the denoise loop, ended by fetching the latents to
the host, divided by the step count of the plan (also when a handler
stopped the loop early); a program's first call includes its capture.
Images come back as one (N, H, W, 3) uint8 array (``utils.image.to_pil``
converts).

Palettized weights (``install_palettized``) are served as the JAX package
serves them: dequantized once on the host (``mode="install"``), or kept on
the card as uint8 indices and float32 LUTs and gathered into the module's
parameters for each ``generate_images`` call, inside its timed window, and
freed at its end (``mode="program"``; on the staged path each stage
gathers its own modules').

W8A8 (``enable_w8a8``): the denoiser's large Linear (and optionally
Conv2d) layers served as int8 products with per-tensor activation scales
(``ops/int8.py``, ``compress/w8a8.py``), swapped on the pipeline's own copy
of the module tree; the int8 layers run inside the captured programs.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import time
from typing import Any

import numpy as np
import torch

from ..compress.palettize import PalettizedTensor
from ..models.multilingual import EMBED_DIM, MAX_SEQUENCE_LENGTH
from ..models.safety import CLIP_IMAGE_MEAN, check_images
from ..models.unet import get_guidance_scale_embedding
from ..models.vae import sample_diagonal_gaussian
from ..ops import attention
from ..ops.attention import set_attention_implementation
from ..schedulers import SCHEDULER_MAP
from ..schedulers.base import Scheduler, SchedulerConfig, TimestepSpacing
from ..tokenizer.prompt_weights import empty_chunk_row, weighted_token_chunks
from ..utils import profiling
from ..utils.image import nchw_to_nhwc, pil_to_tensor
from ..utils.numerics import apply_numerics
from ..utils.rng import make_random_source
from .config import PipelineConfiguration
from .program import ProgramCache, jax_key, mesh_key, program_key, weights_fingerprint

TEXT_LEN = 77


def _tokenize_chunked(tokenizer, texts, max_length=TEXT_LEN):
    """Batch tokenization with prompt weights and long-prompt windows ->
    (ids, weights, any_weighted): ids (B, max_length) when every prompt
    fits one window (the rows ``tokenize`` gives a prompt without the
    syntax), else (B, k, max_length) for the longest prompt's k windows,
    shorter prompts padded with BOS+EOS rows."""
    per = [weighted_token_chunks(tokenizer, t, max_length) for t in texts]
    k = max(ids.shape[0] for ids, _, _ in per)
    any_w = any(aw for _, _, aw in per)
    if k == 1:
        return (np.stack([ids[0] for ids, _, _ in per]),
                np.stack([w[0] for _, w, _ in per]), any_w)
    empty = empty_chunk_row(tokenizer, max_length)
    rows, wrows = [], []
    for ids, w, _ in per:
        pad = k - ids.shape[0]
        rows.append(np.concatenate([ids, np.tile(empty, (pad, 1))]))
        wrows.append(np.concatenate([w, np.ones((pad, max_length), np.float32)]))
    return np.stack(rows), np.stack(wrows), any_w


def encode_text_chunked(encode, ids: torch.Tensor):
    """Run a CLIP encoder over possibly windowed ids: (B, k, L) windows run
    as one (B*k, L) batch -> (encoder outputs, (B, k, L) or None)."""
    if ids.ndim == 2:
        return encode(ids), None
    B, k, L = ids.shape
    return encode(ids.reshape(B * k, L)), (B, k, L)


def _reseq(x, shape3):
    """(B*k, L, C) hidden states -> (B, k*L, C)."""
    B, k, L = shape3
    return x.reshape(B, k * L, x.shape[-1])


def apply_prompt_weights(ctx, weights):
    """Scale each token's hidden state by its prompt weight, then restore
    each prompt row's mean (the a1111 'original' renormalisation), in the
    context's dtype.  ``weights``: (B, S) matching ``ctx`` (B, S, C)."""
    w = weights[..., None].to(ctx.dtype)
    mean_before = ctx.mean(dim=(1, 2), keepdim=True)
    scaled = ctx * w
    return scaled * (mean_before / scaled.mean(dim=(1, 2), keepdim=True))


def _host_nhwc(x: torch.Tensor) -> np.ndarray:
    """NCHW device latents -> NHWC float32 on the host."""
    return x.permute(0, 2, 3, 1).float().cpu().numpy()


def _nchw_host(x) -> np.ndarray:
    """An NHWC host array -> a contiguous NCHW float32 one."""
    return np.ascontiguousarray(np.asarray(x, np.float32).transpose(0, 3, 1, 2))


def _multilingual_rows(embed_fn, text: str) -> np.ndarray:
    """``embed_fn(text)`` cut or zero-padded to (MAX_SEQUENCE_LENGTH,
    EMBED_DIM) float32."""
    e = np.asarray(embed_fn(text), np.float32)[:MAX_SEQUENCE_LENGTH]
    if e.shape[-1] != EMBED_DIM:
        raise ValueError(f"multilingual embed_fn must return (S, {EMBED_DIM}), got {e.shape}")
    return np.pad(e, ((0, MAX_SEQUENCE_LENGTH - e.shape[0]), (0, 0)))


@dataclasses.dataclass
class PipelineProgress:
    """What a progress handler gets after each step: ``step`` of
    ``step_count`` (the plan's), the latents (N, h, w, C) NHWC and, with
    ``use_denoised_intermediates``, the step's predicted clean latents."""

    pipeline: Any
    step: int
    step_count: int
    latents: np.ndarray
    denoised: np.ndarray | None = None

    @property
    def current_images(self) -> np.ndarray:
        """The denoised (else the current) latents decoded to (N, H, W, 3)
        uint8; runs the VAE decoder."""
        return self.pipeline.decode_latents(
            self.denoised if self.denoised is not None else self.latents)


@dataclasses.dataclass
class GenerationResult:
    images: np.ndarray  # (N, H, W, 3) uint8
    latents: np.ndarray  # (N, h, w, C) float32, NHWC as in the JAX package
    nsfw_flags: list[bool]
    seconds_per_step: float


@dataclasses.dataclass
class _Generation:
    """What the host decides for one generation, which the body bakes in:
    the configuration, the scheduler and its plan, the sizes and the
    switches derived from them."""

    cfg: PipelineConfiguration
    scheduler: Scheduler
    plan: Any
    N: int
    h: int
    w: int
    img2img: bool
    inpaint: bool
    unet9: bool
    ip_on: bool
    guidance_on: bool
    #: the guidance-embedding width of an LCM UNet (None: CFG as usual)
    tcp: int | None


class _HostWeights:
    """A module's parameters and buffers packed into one host buffer
    (pinned when ``pin``), each tensor a view of it: one copy moves the
    module to the card, and rebinding the views puts it back."""

    ALIGN = 256

    def __init__(self, module: torch.nn.Module, pin: bool):
        self.tensors = list(dict.fromkeys((*module.parameters(), *module.buffers())))
        sizes = [t.numel() * t.element_size() for t in self.tensors]
        self.offsets, total = [], 0
        for n in sizes:
            self.offsets.append(total)
            total += -(-n // self.ALIGN) * self.ALIGN
        self.flat = torch.empty(total, dtype=torch.uint8, pin_memory=pin)
        with torch.no_grad():
            for t, off in zip(self.tensors, self.offsets):
                view = self._view(self.flat, t, off)
                view.copy_(t.detach())
                t.data = view
        self.nbytes = total

    @staticmethod
    def _view(flat, t, off):
        n = t.numel() * t.element_size()
        return flat[off:off + n].view(t.dtype).view(t.shape)

    def to(self, device):
        """Rebind every tensor to a copy of the buffer on ``device``."""
        dev = self.flat.to(device, non_blocking=True)
        for t, off in zip(self.tensors, self.offsets):
            t.data = self._view(dev, t, off)

    def back(self):
        """Rebind every tensor to its host view (the device copy is freed
        with its last reference)."""
        for t, off in zip(self.tensors, self.offsets):
            t.data = self._view(self.flat, t, off)


def _own_tree(module: torch.nn.Module, names) -> torch.nn.Module:
    """A copy of ``module`` in which every module on the way to one of
    ``names`` (dotted submodule names) is a shallow copy with its own table
    of children, so that swapping those children leaves ``module`` as it
    is; parameters, buffers and every other submodule are shared."""

    def own(m):
        c = copy.copy(m)
        c._modules = type(m._modules)(m._modules)
        owned.add(id(c))
        return c

    owned: set[int] = set()
    root = own(module)
    for name in names:
        node = root
        for part in name.split(".")[:-1]:
            if id(node._modules[part]) not in owned:
                node._modules[part] = own(node._modules[part])
            node = node._modules[part]
    return root


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
    and inpainting; ``SafetyChecker``; ``ControlNetModel``s, one per
    ``controlnet_inputs`` image at generation time) in the dtypes they
    should compute in; they are moved to ``device``.
    ``multilingual_encoder``: ``(MultilingualProjection, embed_fn)``, where
    the host ``embed_fn(text)`` returns (S, 512) embeddings; it replaces
    the CLIP text encoder.
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
                 multilingual_encoder=None,
                 device: str | torch.device = "cuda"):
        apply_numerics()
        self.device = torch.device(device)

        def on_device(module):
            return None if module is None else module.to(self.device).eval()

        self.tokenizer = tokenizer
        self.text_encoder = on_device(text_encoder)
        self.unet = on_device(unet)
        self.vae_decoder = on_device(vae_decoder)
        self.vae_encoder = on_device(vae_encoder)
        self.safety_checker = on_device(safety_checker)
        self.controlnets = [on_device(net) for net in controlnets]
        self.multilingual_encoder = (
            None if multilingual_encoder is None
            else (on_device(multilingual_encoder[0]), multilingual_encoder[1]))
        self.scheduler_config = scheduler_config or SchedulerConfig()
        self.text_embedding_key = text_embedding_key
        #: program mode: module key -> ({parameter key: PalettizedTensor on
        #: the device}, install dtype)
        self.palettized_side: dict[str, tuple[dict[str, PalettizedTensor], torch.dtype]] = {}
        #: set by load_ip_adapter: (IPImageProjection or IPResampler, the
        #: vision encoder's output it takes) and the CLIPVisionEncoder
        self.ip_projection = None
        self.ip_image_encoder = None
        #: apply_lora: pipeline attribute -> {module name: pristine weight}
        self._lora_originals: dict[str, dict] = {}
        self.applied_loras: list[tuple[str, float]] = []
        #: load_textual_inversion: (token, vectors)
        self.textual_inversions: list[tuple[str, int]] = []
        #: "program" (the default: one captured program per key on the
        #: card) or "eager" (the same body launched op by op)
        self.execution = "program"
        self._programs = ProgramCache()
        #: shard: the (dp, tp) DeviceMesh the modules are placed on
        self.mesh = None
        #: offload_params_to_host: id(module) -> its packed host weights
        self._host_weights: dict[int, _HostWeights] = {}
        #: the staged path's last transfers: (stage, bytes, seconds)
        self.stage_transfers: list[tuple[str, int, float]] = []
        #: enable_w8a8: {module name: (int8 weight, float32 scale)} of the
        #: denoiser layers served as int8, their activation scales and the
        #: skip patterns in effect
        self.int8_weights: dict | None = None
        self.int8_act_scales = None
        self.int8_skip_patterns: tuple = ()

    def __copy__(self):
        """A shallow copy shares the modules but not the programs, which
        may have been captured against other modules."""
        out = object.__new__(type(self))
        out.__dict__.update(self.__dict__)
        out._programs = ProgramCache()
        return out

    @property
    def programs(self) -> ProgramCache:
        """The captured programs by key, with their capture records."""
        return self._programs

    def clear_programs(self):
        """Drop every captured program (and its memory pool)."""
        self._programs.clear()

    # -- LoRA adapters -----------------------------------------------------------

    #: the adapter target that addresses the denoiser (SD3: "transformer")
    _LORA_DENOISER_TARGET = "unet"

    def apply_lora(self, lora, scale: float = 1.0):
        """Merge a LoRA adapter into the pipeline's weights: ``lora`` a
        .safetensors path (kohya, SDXL's sgm names among them, or diffusers
        PEFT) or a ``convert.lora.LoRAAdapter``; each weight gains ``scale *
        (alpha / rank) * up @ down``.  Repeated calls stack.  Apply before
        ``install_palettized``.  A target this pipeline has no component for
        raises ``ValueError``."""
        self._refuse_sharded("apply_lora")
        from ..convert.lora import TARGET_TE, TARGET_TE2, LoRAAdapter, load_lora, merge_lora

        adapter = lora if isinstance(lora, LoRAAdapter) else load_lora(lora)
        attr_map = {self._LORA_DENOISER_TARGET: "unet", TARGET_TE: "text_encoder"}
        if hasattr(self, "text_encoder2"):
            attr_map[TARGET_TE2] = "text_encoder2"
        for target in sorted(adapter.targets()):
            attr = attr_map.get(target)
            if attr is None or getattr(self, attr) is None:
                raise ValueError(f"LoRA {adapter.name!r} targets {target!r}, which this "
                                 "pipeline has no component for")
            merge_lora(getattr(self, attr), adapter, target, scale,
                       self._lora_originals.setdefault(attr, {}))
        self.applied_loras.append((adapter.name, scale))
        return self

    def clear_loras(self):
        """Put back the weights every ``apply_lora`` changed, bit for bit."""
        self._refuse_sharded("clear_loras")
        from ..convert.lora import restore_loras

        for attr, originals in self._lora_originals.items():
            restore_loras(getattr(self, attr), originals)
        self._lora_originals = {}
        self.applied_loras = []
        return self

    # -- IP-Adapter --------------------------------------------------------------

    def load_ip_adapter(self, source, image_encoder):
        """Load an IP-Adapter: ``source`` an h94-format checkpoint
        (.safetensors or torch .bin, BASE or PLUS, told apart by its
        ``latents``) or its nested dict; ``image_encoder`` a
        ``CLIPVisionEncoder`` (used as it is) or a transformers
        ``CLIPVisionModelWithProjection`` directory (loaded in the UNet's
        dtype).  Each cross attention of the UNet gets its ``to_k_ip`` /
        ``to_v_ip`` Linear and the projection is built, all in the UNet's
        dtype on its device.  ``ValueError`` for a denoiser that is not a
        UNet, a checkpoint of another UNet, or a PLUS resampler whose output
        is not the UNet's cross-attention width."""
        self._refuse_sharded("load_ip_adapter")
        from ..convert.ip_adapter import (install_ip_projections, load_ip_adapter_state,
                                          port_ip_adapter, resampler_geometry)
        from ..models.ip_adapter import IPImageProjection, IPResampler
        from ..models.unet import UNetConfig

        if not isinstance(self.unet.config, UNetConfig):
            raise ValueError("IP-Adapter checkpoints target UNet denoisers (SD/SDXL); "
                             f"this pipeline's denoiser is {type(self.unet).__name__}")
        image_proj, ip_layers = load_ip_adapter_state(source)
        ported = port_ip_adapter(self.unet.config, ip_layers)
        w = self.unet.conv_in.weight
        cross = self.unet.config.cross_attention_dim
        if "latents" in image_proj:  # PLUS: the resampler over patch states
            geom = resampler_geometry(image_proj)
            if geom["output_dim"] != cross:
                raise ValueError(f"adapter output dim {geom['output_dim']} != UNet "
                                 f"cross-attention dim {cross} — wrong base model?")
            proj = IPResampler(**geom, embedding_dim=image_proj["proj_in.weight"].shape[1])
            embed_key = "penultimate"
        else:
            proj = IPImageProjection(image_proj["proj.weight"].shape[1], cross,
                                     image_proj["proj.weight"].shape[0] // cross)
            embed_key = "image_embeds"
        proj.load_state_dict(image_proj, strict=True)
        install_ip_projections(self.unet, ported)
        if not isinstance(image_encoder, torch.nn.Module):
            from ..convert.clip_vision import load_clip_vision

            image_encoder = load_clip_vision(image_encoder, dtype=w.dtype, device=self.device)
        self.ip_projection = (proj.to(device=w.device, dtype=w.dtype).eval(), embed_key)
        self.ip_image_encoder = image_encoder.to(self.device).eval()
        self._weights_changed()
        return self

    def _ip_inputs(self, cfg: PipelineConfiguration, N: int) -> dict:
        """``ip_adapter_image`` (an (S, S, 3) or (N, S, S, 3) array in [0,
        1], or a PIL image resized to S) as "ip_image", (N, 3, S, S); for
        PLUS also "ip_neutral", an image at the CLIP mean."""
        S = self.ip_image_encoder.config.image_size
        im = cfg.ip_adapter_image
        if not isinstance(im, np.ndarray):
            im = pil_to_tensor(im, size=(S, S), value_range=(0.0, 1.0))
        im = np.asarray(im, np.float32)
        if im.ndim == 3:
            im = im[None]
        out = {"ip_image": _nchw_host(np.broadcast_to(im, (N, S, S, 3)))}
        if self.ip_projection[1] == "penultimate":
            out["ip_neutral"] = _nchw_host(np.broadcast_to(CLIP_IMAGE_MEAN, (N, S, S, 3)))
        return out

    def _ip_tokens(self, inputs: dict):
        """(negative, positive) IP-Adapter tokens of ``_ip_inputs``' images.
        BASE projects zeros for the negative branch, PLUS the patch states
        of the image at the CLIP mean."""
        proj, embed_key = self.ip_projection
        enc = self.ip_image_encoder
        emb = enc(inputs["ip_image"])[embed_key]
        if embed_key == "penultimate":
            emb_neg = enc(inputs["ip_neutral"])[embed_key]
        else:
            emb_neg = torch.zeros_like(emb)
        return proj(emb_neg), proj(emb)

    # -- textual inversion -------------------------------------------------------

    def load_textual_inversion(self, source, token: str | None = None) -> list[int]:
        """Load a textual-inversion embedding: ``source`` an a1111 ``.pt``, a
        ``.safetensors`` (``emb_params``, SDXL ``clip_l``/``clip_g``, or the
        diffusers ``{token: tensor}`` form), a dict of those, or an (n, dim)
        array; ``token`` defaults to the name the file carries, else
        ``<stem>``.  Each CLIP encoder's token table grows by the vectors
        (every loaded encoder needs its own, and both must share a vocabulary
        size) and the tokenizers expand ``token`` to their ids, which are
        returned.  On SD3 only the CLIP tokenizers know the placeholder: T5
        reads the text as it is."""
        from pathlib import Path

        from ..convert.textual_inversion import extend_token_embedding, load_ti_embedding

        data, name = load_ti_embedding(source)
        if token is None:
            token = name
            if token is None and isinstance(source, (str, Path)):
                token = f"<{Path(source).stem}>"
            if token is None:
                raise ValueError("pass token= for array sources without an embedded name")
        slots = []  # (key, encoder attribute)
        if self.text_encoder is not None:
            slots.append(("clip_l", "text_encoder"))
        if getattr(self, "text_encoder2", None) is not None:
            slots.append(("clip_g", "text_encoder2"))
        missing = [k for k, _ in slots if k not in data]
        if missing:
            raise ValueError(f"this pipeline's encoders need {[k for k, _ in slots]} "
                             f"vectors; the embedding lacks {missing}")
        bases = {getattr(self, a).config.vocab_size for _, a in slots}
        if len(bases) != 1:
            raise ValueError(f"encoders disagree on vocab size ({bases}); textual "
                             "inversion needs shared token ids")
        base = bases.pop()
        n = data[slots[0][0]].shape[0]
        ids = list(range(base, base + n))
        for key, attr in slots:
            extend_token_embedding(getattr(self, attr), data[key])
        self.tokenizer.add_placeholder(token, ids)
        tok2 = getattr(self, "tokenizer2", None)
        if tok2 is not None:
            tok2.add_placeholder(token, ids)
        self.textual_inversions.append((token, n))
        self._weights_changed()  # a new token table
        return ids

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
        self._refuse_sharded("install_palettized")
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
        self._weights_changed()

    def _palettized_modules(self, modules=None):
        """(module, {parameter key: PalettizedTensor}, install dtype) of each
        module served in program mode (of those in ``modules``, a set of
        ids, when given)."""
        for mk, (pal, dtype) in self.palettized_side.items():
            module = getattr(self, self._PALETTIZED_ATTRS[mk])
            if modules is None or id(module) in modules:
                yield module, pal, dtype

    @torch.no_grad()
    def _materialize_palettized(self, modules=None):
        """Program mode: gather each LUT into its parameter on the
        parameter's device (the indices and LUT moved there when they wait
        in host memory), rounded through the install dtype, held in the
        parameter's dtype."""
        for module, pal, dtype in self._palettized_modules(modules):
            for key, pt in pal.items():
                p = module.get_parameter(key)
                p.data = pt.to(p.device).dequantize().to(dtype).to(p.dtype)

    def _release_palettized(self, modules=None):
        """Program mode: free the dense copies (empty parameters)."""
        for module, pal, _ in self._palettized_modules(modules):
            for key in pal:
                p = module.get_parameter(key)
                p.data = torch.empty(0, dtype=p.dtype, device=p.device)

    # -- W8A8 ------------------------------------------------------------------

    def enable_w8a8(self, act_scales=None, include_convs: bool = False,
                    min_size: int = 1 << 14, skip_patterns=None):
        """Serve the denoiser's large Linear (and with ``include_convs``
        Conv2d) layers as int8 products (``ops/int8.py``), as the JAX
        ``enable_w8a8`` does.  ``act_scales``: {module name or JAX path:
        input absmax} from ``compress.w8a8.capture_activation_scales`` (or
        the JAX package's), or None for ``ConstantScales()``; only the layers
        it has a scale for are served.  ``skip_patterns`` (default
        ``DEFAULT_SKIP_PATTERNS``) are substrings of the port's module names;
        with ``include_convs`` the upsamplers are skipped too when the UNet's
        config names its fused or parity upsamplers, as in JAX.

        The layers are swapped on the pipeline's own copy of the module tree
        (every module on the way to a swapped layer copied, the rest shared):
        the caller's module keeps its float layers, and the pipeline's holds
        the int8 weights in their place.  The int8 layers are the denoiser's
        children, so they travel with it: offloaded to pinned host memory,
        and on the staged path with the base "unet" stage only (the SDXL
        refiner stays as it is).  The programs are dropped: a graph holds the
        activation scales as kernel arguments."""
        self._refuse_sharded("enable_w8a8")
        from ..compress.w8a8 import (
            DEFAULT_SKIP_PATTERNS,
            ConstantScales,
            port_keys,
            quantize_tree_dense_int8,
            w8a8_serving_swap,
        )

        skip = tuple(DEFAULT_SKIP_PATTERNS if skip_patterns is None else skip_patterns)
        cfg = self.unet.config
        if include_convs and (getattr(cfg, "fused_upsample", False)
                              or getattr(cfg, "parity_upsample", False)):
            skip += ("upsamplers.0",)
        scales = ConstantScales() if act_scales is None else port_keys(act_scales, self.unet)
        weights = quantize_tree_dense_int8(self.unet, min_size=min_size, skip_patterns=skip,
                                           include_convs=include_convs)
        weights = {k: v for k, v in weights.items() if k in scales}
        self.unet = _own_tree(self.unet, weights)
        w8a8_serving_swap(self.unet, scales, weights, skip)
        self.int8_weights = {k: (self.unet.get_submodule(k).weight_q,
                                 self.unet.get_submodule(k).w_scale) for k in weights}
        self.int8_act_scales = scales
        self.int8_skip_patterns = skip
        self._weights_changed()
        return self

    # -- weights: offload and stages -------------------------------------------

    def _params_bundle(self) -> dict:
        """The JAX ``_params_bundle``'s keys -> the modules holding those
        weights here (SDXL and SD3 add theirs)."""
        b = {"unet": [self.unet], "controlnets": list(self.controlnets)}
        if self.text_encoder is not None:
            b["text_encoder"] = [self.text_encoder]
        if self.vae_encoder is not None:
            b["vae_encoder"] = [self.vae_encoder]
        if self.multilingual_encoder is not None:
            b["multilingual"] = [self.multilingual_encoder[0]]
        if self.ip_projection is not None:
            b["ip_proj"] = [self.ip_projection[0]]
            b["ip_vision"] = [self.ip_image_encoder]
        return b

    def _stage_bundle(self, stage: str, img2img: bool = False, n_ctrl: int = 0) -> dict:
        """The modules of one stage of the staged path, as the JAX
        ``_stage_bundle`` picks them (:682-703): ``stage`` "encode" (the
        text encoders, the multilingual projection, the IP projection and
        vision tower, the VAE encoder under img2img) or a phase's denoiser
        key ("unet", "refiner") with the ControlNets.  ``n_ctrl``: the
        ControlNets in use (SD3 encodes their control images)."""
        full = self._params_bundle()
        if stage == "encode":
            keys = ["text_encoder", "text_encoder2", "multilingual", "ip_proj", "ip_vision"]
            if img2img:
                keys.append("vae_encoder")
        else:
            keys = [stage, "controlnets"]
        return {k: full[k] for k in keys if k in full}

    def _all_modules(self) -> list[torch.nn.Module]:
        mods = [m for ms in self._params_bundle().values() for m in ms]
        mods += [m for m in (self.vae_decoder, self.safety_checker) if m is not None]
        return list({id(m): m for m in mods}.values())

    def offload_params_to_host(self):
        """Move every module's weights to host memory, pinned when the
        pipeline runs on the card (the JAX ``offload_params_to_host``,
        :613-639).  With ``reduce_memory`` each stage's weights then move
        to the card for that stage and leave it after, so the card holds
        one stage's weights at a time; without it every module moves in for
        each generation.  Generations with offloaded weights run eagerly."""
        pin = self.device.type == "cuda"
        self._host_weights = {id(m): _HostWeights(m, pin) for m in self._all_modules()}

        def host(t):
            t = t.cpu()
            return t.pin_memory() if pin else t

        self.palettized_side = {
            mk: ({k: dataclasses.replace(pt, indices=host(pt.indices), lut=host(pt.lut))
                  for k, pt in pal.items()}, dtype)
            for mk, (pal, dtype) in self.palettized_side.items()}
        self._programs.clear()
        return self

    def _weights_changed(self):
        """Where the JAX package clears its programs: drop them, and pack
        offloaded weights anew so that new tensors are covered."""
        self._programs.clear()
        if self._host_weights:
            self.offload_params_to_host()

    @contextlib.contextmanager
    def _stage(self, name: str, bundle: dict):
        """The modules of ``bundle`` ready for the block: the offloaded ones
        on the card (a module that was not offloaded stays where it is; the
        copy's bytes and seconds go to ``stage_transfers``), and those served
        in program mode with their palettized weights gathered (the JAX stage
        bundle's own ``palettized`` side), freed again after the block."""
        ids = {id(m) for ms in bundle.values() for m in ms}
        packs = list({i: self._host_weights[i] for i in ids if i in self._host_weights}.values())
        if packs:
            sync = torch.cuda.synchronize if self.device.type == "cuda" else (lambda *a: None)
            sync(self.device)
            t0 = time.perf_counter()
            with torch.inference_mode(False):  # parameters take normal tensors
                for pack in packs:
                    pack.to(self.device)
            sync(self.device)
            self.stage_transfers.append((name, sum(p.nbytes for p in packs),
                                         time.perf_counter() - t0))
        with torch.inference_mode(False):
            self._materialize_palettized(ids)
        try:
            yield
        finally:
            with torch.inference_mode(False):
                self._release_palettized(ids)
                for pack in packs:
                    pack.back()

    # -- tensor parallelism ------------------------------------------------------

    def _refuse_sharded(self, what: str):
        if self.mesh is not None:
            raise RuntimeError(f"{what} changes weights that shard() has split over the "
                               "mesh: call it before shard")

    def shard(self, mesh):
        """Place every model's weights onto a (dp, tp) ``DeviceMesh``
        (``parallel.make_mesh``) in place, as the JAX ``shard`` (:640-675):
        the text encoders, the denoisers, the VAE decoder and encoder, the
        safety checker, the ControlNets and the multilingual projection
        follow ``parallel.sharding.param_sharding_rules`` over tp; W8A8 int8
        layers and weights served palettized in program mode stay
        replicated.  Every rank (one process per card) then runs the same
        generation on the same inputs and returns the same result.  The
        programs are dropped; with an NCCL mesh a generation is still one
        captured program, while a gloo group cannot be captured on the card:
        set ``execution = "eager"`` (a captured run raises).  An MMDiT with
        dual-attention blocks (SD3.5-medium) has no rules: ``ValueError``,
        before any weight moves."""
        from ..parallel.sharding import refuse_dual_attention, shard_params

        if self._host_weights:
            raise RuntimeError("shard places weights on the cards; this pipeline's are "
                               "offloaded to the host (offload_params_to_host)")
        if self.mesh is not None:
            raise RuntimeError("this pipeline is sharded already")
        bundle = self._params_bundle()
        modules = [m for key, ms in bundle.items() if key not in ("ip_proj", "ip_vision")
                   for m in ms]
        modules += [m for m in (self.vae_decoder, self.safety_checker) if m is not None]
        palettized = {id(m): set(pal) for m, pal, _ in self._palettized_modules()}
        modules = list({id(m): m for m in modules}.values())
        for module in modules:  # refused before any module is placed
            refuse_dual_attention(module)
        for module in modules:
            shard_params(module, mesh, replicate=palettized.get(id(module), ()))
        self.mesh = mesh
        self._programs.clear()
        return self

    def _check_capturable(self):
        """A captured program on the card needs collectives a graph can hold
        (NCCL); gloo stages through the host, eagerly."""
        if self.mesh is not None and self.device.type == "cuda":
            backends = [str(torch.distributed.get_backend(self.mesh.get_group(axis)))
                        for axis in self.mesh.mesh_dim_names]
            if not all("nccl" in b for b in backends):
                raise RuntimeError(
                    f"this pipeline is sharded over a {'/'.join(sorted(set(backends)))} mesh, "
                    "whose collectives a CUDA graph cannot capture: set "
                    "pipe.execution = 'eager'")

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

    def _tokenize(self, cfg: PipelineConfiguration) -> dict:
        """-> {"ids": (2N or 2, 77) or (2N or 2, k, 77) int32, negatives
        first, and "weights" of the same shape when any prompt is weighted}
        or, with a multilingual encoder, {"ml_embeds": (2N or 2, 256,
        512)}."""
        neg, pos = self._prompt_lists(cfg)
        if self.multilingual_encoder is not None:
            embed_fn = self.multilingual_encoder[1]
            return {"ml_embeds": np.stack([_multilingual_rows(embed_fn, t) for t in neg + pos])}
        ids, weights, any_w = _tokenize_chunked(self.tokenizer, neg + pos)
        out = {"ids": ids}
        if any_w:  # only weighted prompts take the scaling, so the others
            # stay bit-identical to plain tokenization
            out["weights"] = weights
        return out

    def _dev(self, x) -> torch.Tensor:
        """A host array (as ``_tokenize`` makes them) or a tensor already
        on the device (the body's inputs) -> a tensor on the device."""
        if isinstance(x, torch.Tensor):
            return x
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    def _ids(self, token_inputs: dict, key: str) -> torch.Tensor:
        return self._dev(token_inputs[key]).long()

    def _hidden(self, encoder, token_inputs: dict, key: str, out_key: str, weights_key: str):
        """-> (``out_key`` of ``encoder`` over the ids ``key``, windows
        concatenated and ``weights_key`` applied; the encoder's outputs;
        (B, k, L) or None)."""
        out, shape3 = encode_text_chunked(encoder, self._ids(token_inputs, key))
        ctx = out[out_key]
        if shape3 is not None:
            ctx = _reseq(ctx, shape3)
        if weights_key in token_inputs:
            w = self._dev(token_inputs[weights_key])
            ctx = apply_prompt_weights(ctx, w.reshape(w.shape[0], -1))
        return ctx, out, shape3

    def _encode_text(self, token_inputs: dict) -> dict:
        """-> {"context": (2N or 2, S, C), ...}: what the denoiser is
        conditioned on (SD3 adds the pooled vector).  ``token_inputs``:
        ``_tokenize``'s host arrays, or the same as device tensors."""
        if "ml_embeds" in token_inputs:
            proj = self.multilingual_encoder[0]
            return {"context": proj(self._dev(token_inputs["ml_embeds"]))}
        ctx, _, _ = self._hidden(self.text_encoder, token_inputs, "ids",
                                 self.text_embedding_key, "weights")
        return {"context": ctx}

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

    def _phase_unet(self, phase: str):
        """The denoiser of ``phase`` (SDXL maps "refiner" to its refiner)."""
        return self.unet

    def _call_unet(self, phase: str, latents, t, context, added_cond, down_res=None,
                   mid_res=None, **unet_kw):
        """One denoiser call: ``down_res`` / ``mid_res`` the ControlNets'
        residuals; ``unet_kw`` the guidance embedding, the IP-Adapter tokens
        and DeepCache's arguments."""
        return self._phase_unet(phase)(latents, t, context, added_cond,
                                       down_block_residuals=down_res,
                                       mid_block_residual=mid_res, **unet_kw)

    def _call_unet_cached(self, cache: dict | None, full: bool, *args, **kw):
        """``_call_unet`` under DeepCache (``cache`` not None): a full pass
        that stores the deep feature in ``cache["feat"]``, or the shallow
        pass on it."""
        if cache is None:
            return self._call_unet(*args, **kw)
        if full:
            out, cache["feat"] = self._call_unet(*args, return_deep_feature=True, **kw)
            return out
        return self._call_unet(*args, deep_feature=cache["feat"], **kw)

    def _call_controlnet(self, ci: int, latents_in, t, ctx_pos, added_pos, ctrl_input):
        """ControlNet ``ci``'s (down residuals, mid residual).  The UNet
        families condition on the RGB control image (SD3 overrides: the
        pooled vector and VAE-encoded control latents, no mid residual)."""
        net = self.controlnets[ci]
        kw = {}
        if net.config.addition_embed_type is not None:
            kw["added_cond"] = added_pos  # SDXL micro-conditioning
        return net(latents_in, t, ctx_pos, ctrl_input, **kw)

    def _prepare_control_inputs(self, cfg: PipelineConfiguration, ctrl_images):
        """What the nets take from the control images, once per generation:
        the images themselves here (SD3 VAE-encodes them)."""
        return ctrl_images

    def _controlnet_stage(self, latents_in, t, ctx_pos, added_pos, ctrl_inputs):
        """The ControlNets on the scaled latents with the positive
        conditioning, one per control input -> (down residuals, mid
        residual), summed over the nets in order (the mid residuals when
        there are any); (None, None) without control inputs."""
        down = mid = None
        for ci, ctrl in enumerate(ctrl_inputs):
            d, m = self._call_controlnet(ci, latents_in, t, ctx_pos, added_pos, ctrl)
            if down is None:
                down, mid = list(d), m
            else:
                down = [a + b for a, b in zip(down, d)]
                if m is not None:
                    mid = mid + m
        return down, mid

    def _ctrl_images(self, cfg: PipelineConfiguration, N: int):
        """``controlnet_inputs`` (NHWC arrays, taken as they are, or PIL
        images, read into [0, 1]) -> one (N, 3, H, W) float32 host array
        each."""
        out = []
        for im in cfg.controlnet_inputs:
            if not isinstance(im, np.ndarray):
                im = pil_to_tensor(im, value_range=(0.0, 1.0))
            out.append(_nchw_host(np.broadcast_to(im, (N,) + tuple(im.shape[-3:]))))
        return out

    def _check_deepcache(self, cfg: PipelineConfiguration, num_steps: int):
        """The JAX pipeline's guards on ``deepcache_interval`` dc > 1: a
        denoiser with a shallow/deep split, no serial CFG, and dc below the
        longest phase.  A single phase is measured by min(step_count,
        plan.num_steps): PNDM's plan has one call more than the steps, and
        img2img's strength slice fewer."""
        dc = cfg.deepcache_interval
        if dc == 1:
            return
        if not self.supports_deepcache:
            raise ValueError("deepcache_interval > 1 is not supported for this model family "
                             "(no shallow/deep UNet split)")
        if cfg.unet_batch_one:
            raise ValueError("deepcache_interval > 1 is incompatible with unet_batch_one "
                             "(serial CFG parity)")
        phases = self._denoise_phases(cfg, num_steps)
        longest = (min(cfg.step_count, num_steps) if len(phases) == 1
                   else max(end - start for start, end, _ in phases))
        if longest > 1 and dc >= longest:
            raise ValueError(
                f"deepcache_interval ({dc}) must be < step_count (longest denoise phase: "
                f"{longest} steps): at interval >= phase length only the phase's first step "
                "runs the deep UNet and every later step reuses its stale deep features")

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

    def _host_inputs(self, gen: _Generation) -> dict:
        """Everything the body reads, made on the host: ``_tokenize``'s
        arrays (ids and masks as int64) and flags, the timesteps, the noise
        (N, C, h, w) and the step noises (steps, N, C, h, w), and as the
        configuration asks the starting image (N, 3, H, W), the pixel mask
        (N, 1, H, W), the control images "ctrl_<i>" and the IP-Adapter's
        images.  Arrays are contiguous; anything else is a host flag."""
        with profiling.span("pipeline.host_inputs"):
            cfg, N, h, w = gen.cfg, gen.N, gen.h, gen.w
            out = {}
            for key, v in self._tokenize(cfg).items():
                if isinstance(v, np.ndarray) and key.startswith(("ids", "mask")):
                    v = v.astype(np.int64)
                out[key] = np.ascontiguousarray(v) if isinstance(v, np.ndarray) else v
            noise, step_noises = self._noise(
                cfg, N, h, w, gen.plan.num_steps if gen.scheduler.needs_noise else 0)
            out["noise"] = _nchw_host(noise)
            if step_noises is not None:
                out["step_noises"] = np.ascontiguousarray(step_noises.transpose(0, 1, 4, 2, 3))
            out["timesteps"] = np.ascontiguousarray(gen.plan.timesteps)
            ds = self.vae_downscale
            H, W = h * ds, w * ds
            if gen.img2img:
                image = cfg.starting_image
                if not isinstance(image, np.ndarray):
                    image = pil_to_tensor(image, size=(H, W))
                out["image"] = _nchw_host(np.broadcast_to(image, (N, H, W, 3)))
            if gen.inpaint:
                out["mask_px"] = _nchw_host(_mask_pixels(cfg.mask_image, N, H, W))
            for i, im in enumerate(self._ctrl_images(cfg, N)):
                out[f"ctrl_{i}"] = im
            if gen.ip_on:
                out.update(self._ip_inputs(cfg, N))
            return out

    def _start(self, gen: _Generation, inputs: dict):
        """-> (latents, inpainting state): the first latents (NCHW) and, for
        inpainting, {"mask": latent mask, and "extras9" (9-channel UNet) or
        "z0" and "noise" (4-channel)}, as the JAX encode stage builds them."""
        plan, scheduler, N, h, w = gen.plan, gen.scheduler, gen.N, gen.h, gen.w
        noise = inputs["noise"]
        if not gen.img2img:
            return noise * plan.init_noise_sigma, None
        ds = self.vae_downscale
        image = inputs["image"]
        scale = gen.cfg.encoder_scale_factor or self.default_latent_scale
        # the parity RNG modes use the single host draw for the encoder too
        z0 = sample_diagonal_gaussian(self.vae_encoder(image), noise) * scale
        latents = scheduler.add_noise(plan, z0, noise)
        if not gen.inpaint:
            return latents, None
        mask_px = inputs["mask_px"]
        # latent-resolution mask by area pooling of the pixel mask
        mask = mask_px.reshape(N, 1, h, ds, w, ds).mean(dim=(3, 5))
        if gen.unet9:
            masked = image * (1.0 - mask_px)
            masked_z0 = sample_diagonal_gaussian(self.vae_encoder(masked), noise) * scale
            return latents, {"mask": mask, "extras9": torch.cat([mask, masked_z0], dim=1)}
        return latents, {"mask": mask, "z0": z0, "noise": noise}

    def _encode_stage(self, gen: _Generation, inputs: dict) -> dict:
        """What the JAX encode stage (``init_run``) makes: the text
        conditioning, the IP-Adapter tokens, an LCM UNet's guidance
        embedding, the first latents with the scheduler state and the
        inpainting state, and what the ControlNets take."""
        cfg = gen.cfg
        text = self._encode_text(inputs)
        ip_tokens = self._ip_tokens(inputs) if gen.ip_on else None
        w_emb = None
        if gen.tcp:
            w_emb = get_guidance_scale_embedding(
                torch.full((gen.N,), float(cfg.guidance_scale) - 1.0, dtype=torch.float32,
                           device=self.device), gen.tcp)
        latents, inpaint = self._start(gen, inputs)
        ctrl = [inputs[f"ctrl_{i}"] for i in range(len(cfg.controlnet_inputs))]
        if ctrl:
            ctrl = self._prepare_control_inputs(cfg, ctrl)
        return dict(latents=latents, state=gen.scheduler.initial_state(gen.plan, latents),
                    text=text, ip_tokens=ip_tokens, w_emb=w_emb, inpaint=inpaint, ctrl=ctrl)

    def _denoise_stage(self, gen: _Generation, enc: dict, inputs: dict, phases,
                       progress_handler=None):
        """``phases`` of the denoise loop from ``enc``'s latents and state;
        -> (latents, state, stopped by the handler)."""
        return self._denoise_loop(
            gen.cfg, enc["latents"], enc["text"], gen.N, gen.plan, gen.scheduler,
            gen.guidance_on, float(gen.cfg.guidance_scale), inputs["timesteps"], phases,
            enc["state"], inputs.get("step_noises"), enc["inpaint"], enc["w_emb"],
            enc["ctrl"], progress_handler, enc["ip_tokens"])

    def _body(self, gen: _Generation, inputs: dict, progress_handler=None) -> torch.Tensor:
        """The generation from its inputs to the final latents (N, C, h, w)
        float32: the JAX ``full_run``."""
        enc = self._encode_stage(gen, inputs)
        phases = self._denoise_phases(gen.cfg, gen.plan.num_steps)
        return self._denoise_stage(gen, enc, inputs, phases, progress_handler)[0]

    def _denoise_loop(self, cfg, latents, text, N, plan, scheduler, guidance_on, g, timesteps,
                      phases, state, step_noises=None, inpaint=None, timestep_cond=None,
                      ctrl_inputs=(), progress_handler=None, ip_tokens=None):
        """The denoise loop on NCHW float32 latents: ``phases`` [(start, end,
        phase)] in turn over one scheduler ``state``, as the JAX package's
        consecutive scans.  ``timesteps`` the plan's on the device;
        ``step_noises`` (steps, N, C, h, w) device noise for a scheduler
        that needs it; ``inpaint`` the inpainting state of ``_start``;
        ``timestep_cond`` the guidance embedding of a guidance-embedded UNet
        (its base phase only); ``ctrl_inputs`` one per ControlNet (the
        control images, or what ``_prepare_control_inputs`` made of them),
        the nets running in every phase; ``progress_handler`` called after
        every step, the loop ending when it returns False; ``ip_tokens``
        the IP-Adapter's (negative, positive) tokens, for the base UNet's
        calls (the SDXL refiner has no IP projections).  -> (latents,
        state, whether the handler stopped the loop)."""
        inpaint = inpaint or {}
        dc = cfg.deepcache_interval
        serial = guidance_on and cfg.unet_batch_one
        for start, end, phase in phases:
            ctx_neg, ctx_pos, added_neg, added_pos = self._phase_conditioning(
                cfg, text, N, phase)
            base = phase == "unet"
            # 9-channel inputs and the guidance embedding reach the base UNet
            # only (the SDXL refiner has neither)
            extras9 = inpaint.get("extras9") if base else None
            tc_kw = {"timestep_cond": timestep_cond} if base and timestep_cond is not None else {}
            ip_neg = ip_pos = ip2 = {}
            if base and ip_tokens is not None:
                def ip_kw(tokens):
                    return {"ip_context": tokens, "ip_scale": float(cfg.ip_adapter_scale)}

                ip_neg, ip_pos, ip2 = (ip_kw(ip_tokens[0]), ip_kw(ip_tokens[1]),
                                       ip_kw(torch.cat(ip_tokens)))
            ctx2 = added2 = None
            if guidance_on and not serial:
                ctx2 = torch.cat([ctx_neg, ctx_pos])
                if added_pos is not None:
                    added2 = {key: torch.cat([added_neg[key], added_pos[key]])
                              for key in added_pos}
            # the deep-feature cache starts empty with each phase: its first
            # step is a full pass (the JAX scan's zero feature is never read)
            cache = {} if dc > 1 else None
            for i in range(start, end):
                t = timesteps[i]
                full = (i - start) % dc == 0
                lat_in = scheduler.scale_model_input(plan, state, latents, i)
                down_res, mid_res = self._controlnet_stage(lat_in, t, ctx_pos, added_pos,
                                                           ctrl_inputs)
                if extras9 is not None:
                    lat_in = torch.cat([lat_in, extras9.to(lat_in.dtype)], dim=1)
                if not guidance_on:
                    noise_pred = self._call_unet_cached(cache, full, phase, lat_in, t, ctx_pos,
                                                        added_pos, down_res, mid_res, **tc_kw,
                                                        **ip_pos)
                else:
                    if serial:
                        out_neg = self._call_unet(phase, lat_in, t, ctx_neg, added_neg,
                                                  down_res, mid_res, **ip_neg)
                        out_pos = self._call_unet(phase, lat_in, t, ctx_pos, added_pos,
                                                  down_res, mid_res, **ip_pos)
                    else:
                        dr2 = None if down_res is None else [torch.cat([r, r]) for r in down_res]
                        mr2 = None if mid_res is None else torch.cat([mid_res, mid_res])
                        out = self._call_unet_cached(cache, full, phase,
                                                     torch.cat([lat_in, lat_in]), t, ctx2,
                                                     added2, dr2, mr2, **ip2)
                        out_neg, out_pos = out.chunk(2)
                    noise_pred = out_neg + g * (out_pos - out_neg)
                denoised = None
                if progress_handler is not None and cfg.use_denoised_intermediates:
                    denoised = scheduler.pred_x0(plan, state, noise_pred, i, latents)
                noise = step_noises[i] if scheduler.needs_noise else None
                state, latents = scheduler.step(plan, state, noise_pred, i, latents, noise=noise)
                if "z0" in inpaint:
                    # the known region at the next step's noise level
                    z0, m = inpaint["z0"], inpaint["mask"]
                    known = (z0 if i + 1 >= plan.num_steps else
                             scheduler.add_noise(plan, z0, inpaint["noise"], i + 1))
                    latents = m * latents + (1.0 - m) * known
                if progress_handler is not None:
                    progress = PipelineProgress(
                        self, i + 1, plan.num_steps, _host_nhwc(latents),
                        None if denoised is None else _host_nhwc(denoised))
                    if progress_handler(progress) is False:
                        return latents, state, True
        return latents, state, False

    # -- decode ----------------------------------------------------------------

    def _decode_body(self, z: torch.Tensor, scale: float, shift: float) -> torch.Tensor:
        """NHWC latents -> (N, 3, H, W) uint8 pixels."""
        x = self.vae_decoder(z.permute(0, 3, 1, 2) / scale + shift)
        x = torch.clamp(x * 0.5 + 0.5, 0.0, 1.0)
        return torch.round(x * 255.0).to(torch.uint8)

    @torch.inference_mode()
    def decode_latents(self, latents: np.ndarray,
                       cfg: PipelineConfiguration | None = None) -> np.ndarray:
        """Scaled NHWC latents -> (N, H, W, 3) uint8 images: a program of
        its own per (N, h, w) and factors, as the JAX ``_decode_fn``."""
        scale = ((cfg.decoder_scale_factor if cfg else None)
                 or self.default_latent_scale)
        shift = ((cfg.decoder_shift_factor if cfg else None)
                 or self.default_latent_shift)
        z = np.ascontiguousarray(latents, np.float32)
        with profiling.span("pipeline.decode", images=z.shape[0]):
            if self._captures():
                dtype = next(self.vae_decoder.parameters()).dtype
                inputs = {"z": z}
                with profiling.span("program.lookup", kind="decode"):
                    # the attention dispatch in effect is baked into the graph too
                    prog = self._programs.get(
                        ("decode", scale, shift, str(dtype), z.shape,
                         attention.ATTENTION_IMPLEMENTATION_IN_EFFECT.value,
                         mesh_key(self.mesh)),
                        weights_fingerprint(self._all_modules()), inputs,
                        lambda b: self._decode_body(b["z"], scale, shift), self.device,
                        kind="decode")
                pixels = prog(inputs)
            else:
                with self._stage("decode", {"vae_decoder": [self.vae_decoder]}):
                    pixels = self._decode_body(self._dev(z), scale, shift)
            with profiling.span("pipeline.fetch"):
                return pixels.permute(0, 2, 3, 1).cpu().numpy()

    # -- public API ----------------------------------------------------------------

    def run_safety_checker(self, images: np.ndarray):
        """-> (images with the flagged ones zeroed, nsfw flags)."""
        if self.safety_checker is None:
            return images, [False] * len(images)
        with self._stage("safety", {"safety_checker": [self.safety_checker]}):
            return check_images(self.safety_checker, images)

    def _captures(self, progress_handler=None) -> bool:
        """Whether a generation runs as captured programs (the default):
        not with a progress handler, palettized weights in program mode
        (rebound on every call), offloaded weights (moved on every call) or
        ``execution = "eager"``.  Raises for a capture on the card of a
        pipeline sharded over a mesh that is not NCCL's."""
        if self.execution not in ("program", "eager"):
            raise ValueError(f"execution must be 'program' or 'eager', got {self.execution!r}")
        captures = (self.execution == "program" and progress_handler is None
                    and not self.palettized_side and not self._host_weights)
        if captures:
            self._check_capturable()
        return captures

    def _plan_generation(self, cfg: PipelineConfiguration, image_hw,
                         progress_handler) -> _Generation:
        """The JAX ``generate_images``' checks and the plan."""
        N = cfg.image_count
        h, w = image_hw[0] // self.vae_downscale, image_hw[1] // self.vae_downscale
        scheduler = self._make_scheduler(cfg)
        img2img = cfg.starting_image is not None
        inpaint = cfg.mask_image is not None
        ip_on = cfg.ip_adapter_image is not None
        if ip_on and self.ip_projection is None:
            raise ValueError("ip_adapter_image requires load_ip_adapter(...) first")
        C = self.latent_channels
        unet9 = self.unet.config.in_channels == C + 5
        if inpaint and not img2img:
            raise ValueError("mask_image requires starting_image")
        if unet9 and not inpaint:
            raise ValueError("this checkpoint is a 9-channel inpainting UNet; pass "
                             "starting_image + mask_image")
        if img2img and self.vae_encoder is None:
            raise ValueError("starting_image needs a pipeline with a vae_encoder")
        plan = scheduler.set_timesteps(cfg.step_count,
                                       strength=cfg.strength if img2img else 1.0)
        # a guidance-embedded (LCM) UNet never runs CFG: the scale is an input
        tcp = getattr(self.unet.config, "time_cond_proj_dim", None)
        guidance_on = cfg.guidance_scale > 1.0 and not tcp
        n_ctrl = len(cfg.controlnet_inputs)
        if n_ctrl and n_ctrl != len(self.controlnets):
            raise ValueError("controlnet_inputs count must match loaded controlnets")
        set_attention_implementation(cfg.attention_implementation)
        if cfg.deepcache_interval > 1 and progress_handler is not None:
            raise ValueError("deepcache_interval > 1 is incompatible with a progress_handler "
                             "(the deep-feature cache lives in the one-program scan carry)")
        self._check_deepcache(cfg, plan.num_steps)
        return _Generation(cfg, scheduler, plan, N, h, w, img2img, inpaint, unet9, ip_on,
                           guidance_on, tcp)

    def _program(self, gen: _Generation, inputs: dict):
        """The cached program of this generation's key, built when missing.
        The key: the JAX key's fields, then what the body bakes that JAX's
        key lacks (the encoder's latent scale), the inputs' names, shapes
        and dtypes with the host flags, and the denoiser's dtype."""
        cfg = gen.cfg
        with profiling.span("program.lookup", kind="generation"):
            key = program_key(
                jax_key(cfg, gen.N, gen.h, gen.w, gen.guidance_on, len(cfg.controlnet_inputs),
                        gen.img2img, gen.inpaint, gen.ip_on,
                        cfg.strength if gen.img2img else 1.0,
                        self._conditioning_cache_key(cfg)),
                (cfg.encoder_scale_factor,), inputs, next(self.unet.parameters()).dtype,
                mesh_key(self.mesh))
            return self._programs.get(key, weights_fingerprint(self._all_modules()), inputs,
                                      lambda buffers: self._body(gen, buffers), self.device)

    def _run_staged(self, gen: _Generation, inputs: dict, progress_handler) -> torch.Tensor:
        """The staged path: the encode stage, then each denoise phase, each
        with only its modules' weights on the card (the JAX ``prog["init"]``
        and ``prog["phase_scans"]``)."""
        inputs = {k: self._dev(v) if isinstance(v, np.ndarray) else v for k, v in inputs.items()}
        with self._stage("encode", self._stage_bundle("encode", gen.img2img,
                                                      len(gen.cfg.controlnet_inputs))):
            enc = self._encode_stage(gen, inputs)
        for start, end, phase in self._denoise_phases(gen.cfg, gen.plan.num_steps):
            with self._stage(phase, self._stage_bundle(phase)):
                enc["latents"], enc["state"], stopped = self._denoise_stage(
                    gen, enc, inputs, [(start, end, phase)], progress_handler)
            if stopped:
                break
        return enc["latents"]

    def _conditioning_cache_key(self, cfg: PipelineConfiguration):
        """The JAX key's last field: what the family's conditioning bakes."""
        return ()

    def generate_images(self, cfg: PipelineConfiguration, progress_handler=None,
                        image_hw: tuple[int, int] = (512, 512)) -> GenerationResult:
        """``progress_handler(PipelineProgress) -> bool | None``: called after
        every step; returning False ends the loop, and what the latents are
        then is decoded."""
        with profiling.span("pipeline.plan"):
            cfg.validate()
            gen = self._plan_generation(cfg, image_hw, progress_handler)
        inputs = self._host_inputs(gen)
        self.stage_transfers = []
        path = ("staged" if cfg.reduce_memory
                else "program" if self._captures(progress_handler) else "eager")

        t0 = time.perf_counter()
        with torch.inference_mode(), profiling.span("pipeline.denoise", path=path):
            if path == "staged":
                latents = self._run_staged(gen, inputs, progress_handler)
            elif path == "program":
                latents = self._program(gen, inputs)(inputs)
            else:
                with self._stage("all", self._params_bundle()):
                    latents = self._body(gen, {k: self._dev(v) if isinstance(v, np.ndarray)
                                               else v for k, v in inputs.items()},
                                         progress_handler)
            # the host fetch waits for the device
            with profiling.span("pipeline.fetch"):
                latents = _host_nhwc(latents)
        dt = (time.perf_counter() - t0) / gen.plan.num_steps

        images = self.decode_latents(latents, cfg)
        nsfw = [False] * gen.N
        if not cfg.disable_safety:
            images, nsfw = self.run_safety_checker(images)
        return GenerationResult(images=images, latents=latents,
                                nsfw_flags=nsfw, seconds_per_step=dt)
