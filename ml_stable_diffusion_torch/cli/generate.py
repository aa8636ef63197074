"""Image generation command (port of ml_stable_diffusion_tpu/cli/generate.py).

    python -m ml_stable_diffusion_torch.cli.generate "a cat" -i CHECKPOINT_DIR -o OUT

Every flag of ``sdtpu-generate``, with its name, default and file names,
except:

- ``--rng`` defaults to ``numpy`` (the JAX default ``jax`` draws with
  ``jax.random``; ``--rng jax`` exits with the pipeline's own ValueError);
- ``--compute-units``/``--device`` takes a torch device (``cuda``,
  ``cuda:1``, ``cpu``) and defaults to ``cuda``;
- ``--attention-implementation xla`` selects the port's plain path, so a
  command line written for ``sdtpu-generate`` runs unchanged;
- ``--mesh tp=N | dp=D,tp=T`` runs one process per card under ``torchrun
  --nproc-per-node D*T`` (without a matching ``WORLD_SIZE`` it exits and
  says so); the pipeline is sharded after the adapters, every rank
  generates, and rank 0 writes the images;
- input images are read, and the results written, by ``utils/png.py``; an
  input whose size differs from ``--size`` (or that is not a PNG it reads)
  goes through Pillow (``utils/image.py:pil_to_tensor``), which the
  machine must then have;
- a ``--w8a8-scales`` recipe's ``skip`` list (JAX paths or the port's
  names) is translated to the port's module names before it joins the skip
  patterns.
"""

from __future__ import annotations

import argparse
import functools
import importlib
import json
import logging
import os
from pathlib import Path

logger = logging.getLogger(__name__)

#: ``--attention-implementation`` -> the port's ``AttentionImpl`` value
ATTENTION = {"auto": "auto", "xla": "plain", "flash": "flash"}


def parser_spec() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        "sdtorch-generate", description="Stable Diffusion generation on a CUDA card")
    p.add_argument("prompt", nargs="?", default=None, help="positional prompt")
    p.add_argument("--prompt", dest="prompt_opt", default=None)
    p.add_argument("--negative-prompt", default="")
    p.add_argument("-i", "--checkpoint-path", required=True,
                   help="diffusers-layout checkpoint directory")
    p.add_argument("-o", "--output-path", default=".")
    p.add_argument("--seed", type=int, default=93)
    p.add_argument("--num-inference-steps", "--step-count", type=int, default=50,
                   dest="step_count")
    p.add_argument("--guidance-scale", type=float, default=7.5)
    p.add_argument("--image-count", type=int, default=1)
    p.add_argument("--scheduler", default="PNDM",
                   help="PNDM|DPMSolverMultistep|DDIM|Euler|EulerAncestral|LMS|DiscreteFlow|LCM")
    p.add_argument("--timestep-spacing", default=None,
                   help="linspace|leading|trailing|karras")
    p.add_argument("--timestep-shift", type=float, default=3.0)
    p.add_argument("--deepcache-interval", type=int, default=1,
                   help="run the full UNet only every Nth step, a shallow cached pass "
                        "between (1 = off/exact; SD/SDXL only)")
    p.add_argument("--rng", default="numpy", choices=["jax", "numpy", "torch", "nvidia"],
                   help="host noise stream; 'jax' is not reproduced by this package")
    p.add_argument("--image", default=None, help="img2img input image path")
    p.add_argument("--mask", default=None, metavar="PATH",
                   help="inpainting mask image (white = repaint, black = keep --image "
                        "content); requires --image")
    p.add_argument("--strength", type=float, default=1.0)
    p.add_argument("--size", default="512x512", help="HxW output size")
    p.add_argument("--controlnet-inputs", nargs="*", default=[],
                   help="conditioning image paths, one per loaded controlnet")
    p.add_argument("--disable-safety", action="store_true")
    p.add_argument("--unet-batch-one", action="store_true")
    p.add_argument("--attention-implementation", default="auto",
                   choices=["auto", "xla", "flash"],
                   help="auto | flash (the CUDA kernel) | xla (the plain path)")
    p.add_argument("--fuse-qkv", action="store_true",
                   help="serve-time fused qkv projections for self-attention")
    p.add_argument("--refiner-start", type=float, default=0.8)
    p.add_argument("--custom-vae", default=None)
    p.add_argument("--controlnet", nargs="*", default=[],
                   help="ControlNet checkpoint directories")
    p.add_argument("--save-every", type=int, default=0,
                   help="save intermediate images every N steps")
    p.add_argument("--compute-units", "--device", dest="device", default="cuda",
                   help="torch device: cuda, cuda:1, cpu")
    p.add_argument("--multilingual", action="store_true",
                   help="use a MultilingualTextEncoderProjection artifact instead of the "
                        "CLIP text encoder")
    p.add_argument("--multilingual-projection", default=None, metavar="DIR",
                   help="directory with MultilingualTextEncoderProjection.safetensors "
                        "(default: the checkpoint directory)")
    p.add_argument("--multilingual-embedder", default=None, metavar="MODULE:FUNC",
                   help="python entrypoint fn(text, script)->(S,512)")
    p.add_argument("--script", default="latin",
                   help="writing-script hint passed to the embedder")
    p.add_argument("--lora", action="append", default=[], metavar="PATH[:SCALE]",
                   help="merge a LoRA adapter (.safetensors, kohya or diffusers-PEFT) at "
                        "the given strength; repeatable")
    p.add_argument("--textual-inversion", action="append", default=[],
                   metavar="PATH[:TOKEN]",
                   help="load a textual-inversion embedding (.pt or .safetensors) under the "
                        "given placeholder token (default: the file's name); repeatable")
    p.add_argument("--ip-adapter", default=None, metavar="PATH",
                   help="IP-Adapter checkpoint (.safetensors/.bin); requires "
                        "--ip-image-encoder and --ip-adapter-image")
    p.add_argument("--ip-image-encoder", default=None, metavar="DIR",
                   help="CLIPVisionModelWithProjection checkpoint dir")
    p.add_argument("--ip-adapter-image", default=None, metavar="PATH",
                   help="reference image for IP-Adapter conditioning")
    p.add_argument("--ip-adapter-scale", type=float, default=1.0)
    p.add_argument("--w8a8", action="store_true",
                   help="serve the UNet's large Linear layers as int8 products")
    p.add_argument("--w8a8-scales", default=None, metavar="JSON",
                   help="calibrated activation scales {module_path: absmax} (either "
                        "package's) or a w8a8-analyze recipe (default: constant scales)")
    p.add_argument("--reduce-memory", action="store_true",
                   help="each stage's weights on the card for that stage only")
    p.add_argument("--use-denoised-intermediates", action="store_true",
                   help="--save-every previews decode predicted-x0 instead of the noisy "
                        "latents")
    p.add_argument("--mesh", default=None, metavar="SPEC",
                   help="shard the pipeline over dp*tp cards, one process each, started by "
                        "torchrun --nproc-per-node dp*tp; SPEC is 'tp=N' or 'dp=D,tp=T'; "
                        "rank 0 writes the images")
    return p


def _parse_mesh(spec: str, device):
    """'tp=N' / 'dp=D,tp=T' -> the (dp, tp) mesh over this command's
    processes, one per card, as torchrun starts them (its environment names
    the rank, the world size and the rendezvous); NCCL on the card, gloo on
    the CPU."""
    import torch
    import torch.distributed as dist

    from ..parallel import make_mesh

    kv = dict(part.split("=") for part in spec.split(","))
    dp, tp = int(kv.get("dp", 1)), int(kv.get("tp", 1))
    world = os.environ.get("WORLD_SIZE")
    if world != str(dp * tp):
        raise SystemExit(
            f"--mesh {spec} runs one process per card on {dp * tp} cards: start the command "
            f"with torchrun --nproc-per-node {dp * tp} (WORLD_SIZE is {world or 'unset'})")
    if not dist.is_initialized():
        if device.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    return make_mesh(dp * tp, dp=dp, tp=tp, device_type=device.type)


def _load_embedder(spec: str, script: str):
    """'module:function' -> embed_fn(text)->(S,512), with the script hint
    bound."""
    mod_name, _, fn_name = spec.partition(":")
    fn = getattr(importlib.import_module(mod_name), fn_name)
    return functools.partial(fn, script=script)


def read_image(path, size: tuple[int, int], value_range=(-1.0, 1.0), grey: bool = False):
    """An input image file -> (1, H, W, 3) float32 in ``value_range``, as
    the JAX command's ``pil_to_tensor(Image.open(path)[.convert("L")],
    size)``: a PNG already at ``size`` through ``utils/png.py``, anything
    else through Pillow."""
    from ..utils import png
    from ..utils.image import open_image, pil_to_tensor

    try:
        px = png.read_png(path)
    except ValueError:
        px = None
    if px is not None and px.shape[:2] == tuple(size):
        return png.to_tensor(png.to_grey(px) if grey else px, value_range)
    im = open_image(path)
    return pil_to_tensor(im.convert("L") if grey else im, size=size, value_range=value_range)


def _multilingual(args, device):
    """-> the pipeline's ``(MultilingualProjection, embed_fn)``."""
    import torch

    from ..convert.artifacts import load_module
    from ..models.multilingual import MultilingualProjection

    if not args.multilingual_embedder:
        raise SystemExit(
            "--multilingual needs --multilingual-embedder MODULE:FUNC (an external "
            "fn(text, script)->(S,512) embedding model)")
    proj_dir = Path(args.multilingual_projection or args.checkpoint_path)
    params, _ = load_module(proj_dir, name="MultilingualTextEncoderProjection", device=device)
    if "linear" in params:  # a JAX-written artifact: the Flax Dense
        params = {"linear.weight": params["linear"]["kernel"].t(),
                  "linear.bias": params["linear"]["bias"]}
    proj = MultilingualProjection(hidden_size=params["linear.weight"].shape[0])
    proj.load_state_dict({k: v.to(torch.float32) for k, v in params.items()}, strict=True)
    return proj.to(device).eval(), _load_embedder(args.multilingual_embedder, args.script)


def _w8a8_scales(pipe, path):
    """A ``--w8a8-scales`` file -> (scales, skip patterns or None)."""
    from ..compress.w8a8 import DEFAULT_SKIP_PATTERNS, port_keys

    data = json.loads(Path(path).read_text())
    if "act_scales" not in data:  # flat {module: absmax} from w8a8-calibrate
        return data, None
    # a w8a8-analyze recipe: calibrated scales and the layers that failed
    # their class gates, named in either package's key space
    skip = tuple(port_keys(dict.fromkeys(data.get("skip", ())), pipe.unet))
    return data["act_scales"], tuple(DEFAULT_SKIP_PATTERNS) + skip


def run(args) -> list:
    import torch

    from ..convert.load import load_pipeline
    from ..pipelines.config import PipelineConfiguration
    from ..utils import png
    from ..utils.rng import make_random_source

    make_random_source(args.rng, args.seed)  # --rng jax: the pipeline's own ValueError
    device = torch.device(args.device)
    mesh = _parse_mesh(args.mesh, device) if args.mesh else None
    # every rank generates the same images; the first writes them
    writes = mesh is None or torch.distributed.get_rank() == 0
    prompt = args.prompt_opt or args.prompt or ""
    h, w = (int(x) for x in args.size.split("x"))

    multilingual = _multilingual(args, device) if args.multilingual else None
    pipe = load_pipeline(args.checkpoint_path, custom_vae_dir=args.custom_vae,
                         controlnet_dirs=args.controlnet, fuse_qkv=args.fuse_qkv,
                         multilingual_encoder=multilingual, device=device)
    if args.ip_adapter:
        if not (args.ip_image_encoder and args.ip_adapter_image):
            raise SystemExit("--ip-adapter requires --ip-image-encoder and "
                             "--ip-adapter-image")
        pipe.load_ip_adapter(args.ip_adapter, args.ip_image_encoder)
    for spec in args.textual_inversion:
        # PATH[:TOKEN]: no split at a Windows drive letter or where the tail
        # still holds a separator
        head, sep, tail = spec.rpartition(":")
        path, tok = spec, ""
        if sep and len(head) > 1 and "/" not in tail and "\\" not in tail:
            path, tok = head, tail
        pipe.load_textual_inversion(path, token=tok or None)
    for spec in args.lora:
        # PATH[:SCALE]: the suffix must parse as a float
        path, scale = spec, 1.0
        if ":" in spec:
            head, _, tail = spec.rpartition(":")
            try:
                scale, path = float(tail), head
            except ValueError:
                pass
        pipe.apply_lora(path, scale=scale)
    if args.w8a8:
        scales, skip = _w8a8_scales(pipe, args.w8a8_scales) if args.w8a8_scales else (None,
                                                                                        None)
        pipe.enable_w8a8(scales, skip_patterns=skip)
    if mesh is not None:  # after the adapters: they change whole weights
        pipe.shard(mesh)
    if args.reduce_memory:
        pipe.offload_params_to_host()

    starting_image = (read_image(args.image, (h, w)) if args.image else None)
    ip_adapter_image = None
    if args.ip_adapter_image:
        if pipe.ip_image_encoder is None:
            raise SystemExit("--ip-adapter-image requires --ip-adapter "
                             "(and --ip-image-encoder)")
        S = pipe.ip_image_encoder.config.image_size
        ip_adapter_image = read_image(args.ip_adapter_image, (S, S), (0.0, 1.0))
    mask_image = (read_image(args.mask, (h, w), (0.0, 1.0), grey=True) if args.mask
                  else None)
    controlnet_inputs = [read_image(p, (h, w), (0, 1)) for p in args.controlnet_inputs]

    cfg = PipelineConfiguration(
        prompt=prompt, negative_prompt=args.negative_prompt,
        starting_image=starting_image, mask_image=mask_image,
        ip_adapter_image=ip_adapter_image, ip_adapter_scale=args.ip_adapter_scale,
        strength=args.strength, image_count=args.image_count, step_count=args.step_count,
        seed=args.seed, guidance_scale=args.guidance_scale, refiner_start=args.refiner_start,
        controlnet_inputs=controlnet_inputs, disable_safety=args.disable_safety,
        scheduler=args.scheduler, timestep_spacing=args.timestep_spacing,
        timestep_shift=args.timestep_shift, rng=args.rng, unet_batch_one=args.unet_batch_one,
        use_denoised_intermediates=args.use_denoised_intermediates,
        reduce_memory=args.reduce_memory,
        attention_implementation=ATTENTION[args.attention_implementation],
        deepcache_interval=args.deepcache_interval)

    out_dir = Path(args.output_path)
    out_dir.mkdir(parents=True, exist_ok=True)

    handler = None
    if args.save_every > 0:
        def handler(progress):
            if not writes:
                return True
            if progress.step % args.save_every == 0:
                for i, im in enumerate(progress.current_images):
                    png.write_png(out_dir / _name(prompt, args.seed, i, step=progress.step), im)
            return True

    result = pipe.generate_images(cfg, progress_handler=handler, image_hw=(h, w))
    paths = []
    for i, im in enumerate(result.images if writes else ()):
        paths.append(png.write_png(out_dir / _name(prompt, args.seed, i), im))
        if result.nsfw_flags[i]:
            logger.warning("image %d flagged by safety checker", i)
    logger.info("%.3f s/step; saved %s", result.seconds_per_step, [str(p) for p in paths])
    return paths


def _name(prompt: str, seed: int, idx: int, step: int | None = None) -> str:
    """<prompt-slug>.<seed>.<idx>[.step<N>].png, the JAX command's names."""
    slug = "_".join(prompt.split())[:50] or "image"
    parts = [slug, str(seed), str(idx)]
    if step is not None:
        parts.append(f"step{step}")
    return ".".join(parts) + ".png"


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    run(parser_spec().parse_args(argv))


if __name__ == "__main__":
    main()
