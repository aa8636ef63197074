"""Conversion command: a diffusers checkpoint -> an artifact bundle of the
port's state dicts (port of ml_stable_diffusion_tpu/cli/convert.py).

    python -m ml_stable_diffusion_torch.cli.convert -i CHECKPOINT_DIR -o OUT --convert-all \\
        --check-output-correctness --bundle-resources-for-generation

The JAX command's flags, artifact names (``Unet``, ``TextEncoder``,
``TextEncoder2``, ``TextEncoderT5``, ``MMDiT``, ``RefinerUnet``,
``VAEDecoder``, ``VAEEncoder``, ``SafetyChecker``, ``ControlNet-<dir>``,
``MultilingualTextEncoderProjection``), tokenizer files and ``bundle.json``;
each artifact holds the port module's state dict (``convert/artifacts.py``)
in the dtype the JAX command stores (the denoisers and ControlNets bf16, the
rest float32), which ``convert/load.py:load_pipeline_from_artifacts`` serves
(the JAX pipelines do not read these bundles).  ``--quantize-nbits`` stores
palettized indices and LUTs (``compress/palettize.py:palettize_tree``, the
JAX package's LUTs bit for bit).  ``--check-output-correctness`` reloads
every artifact and compares it to what was saved, then gates each model at
35 dB against its independent torch forward (``convert/verify.py``), on
``--device`` (default ``cuda``).
"""

from __future__ import annotations

import argparse
import json
import logging
import shutil
from pathlib import Path

logger = logging.getLogger(__name__)


def parser_spec():
    p = argparse.ArgumentParser("sdtorch-convert")
    p.add_argument("--model-version", "-i", dest="checkpoint", required=True,
                   help="diffusers-layout checkpoint directory")
    p.add_argument("-o", "--output-dir", required=True)
    p.add_argument("--convert-unet", action="store_true")
    p.add_argument("--convert-text-encoder", action="store_true")
    p.add_argument("--convert-vae-decoder", action="store_true")
    p.add_argument("--convert-vae-encoder", action="store_true")
    p.add_argument("--convert-safety-checker", action="store_true")
    p.add_argument("--convert-mmdit", action="store_true", help="SD3 transformer")
    p.add_argument("--convert-t5", action="store_true", help="SD3 text_encoder_3")
    p.add_argument("--convert-controlnet", nargs="+", default=(), metavar="DIR",
                   help="diffusers ControlNet checkpoint dirs")
    p.add_argument("--refiner-version", default=None, metavar="DIR",
                   help="SDXL refiner checkpoint dir; converts its UNet as RefinerUnet")
    p.add_argument("--convert-all", action="store_true",
                   help="convert every module the checkpoint's family needs")
    p.add_argument("--quantize-nbits", type=int, default=None, choices=[1, 2, 4, 6, 8],
                   help="palettize the UNet/MMDiT, text encoder and ControlNet weights; "
                        "artifacts store packed indices+LUT")
    p.add_argument("--palettize-min-size", type=int, default=None,
                   help="min tensor elements to palettize (default 1e5)")
    p.add_argument("--custom-vae", default=None)
    p.add_argument("--bundle-resources-for-generation", action="store_true",
                   help="copy tokenizer files + scheduler config next to the artifacts and "
                        "write bundle.json")
    p.add_argument("--convert-multilingual-projection", default=None, metavar="TORCH_CKPT",
                   help="convert a user-trained multilingual projection (torch Linear "
                        "state dict)")
    p.add_argument("--check-output-correctness", action="store_true",
                   help="reload each saved artifact and verify equality, and gate every "
                        "model at 35 dB against an independent torch forward")
    p.add_argument("--device", default="cuda", help="torch device: cuda, cuda:1, cpu")
    return p


def _family(src: Path) -> str:
    index = src / "model_index.json"
    if index.exists():
        return json.loads(index.read_text()).get("_class_name", "StableDiffusionPipeline")
    return "StableDiffusionPipeline"


def run(args) -> dict:
    """-> {"psnr_db": {module: each convert-time gate's PSNR}}."""
    import torch

    from ..compress.palettize import PalettizedTensor, palettize_tree
    from ..convert import artifacts, load, verify

    src = Path(args.checkpoint)
    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    dev = torch.device(args.device)
    all_ = args.convert_all
    family = _family(src)
    is_xl = "XL" in family
    is_sd3 = "StableDiffusion3" in family
    check = args.check_output_correctness
    gates = {}  # label -> PSNR (dB) of each convert-time gate

    def exists(name):
        # idempotent conversion: skip what is there
        if (out / f"{name}.safetensors").exists():
            logger.info("%s exists, skipping", name)
            return True
        return False

    def save(name, params, config):
        artifacts.save_module(out, params, config=config, name=name)
        if check:  # the artifact reloads as what was saved, bit for bit
            loaded, _ = artifacts.load_module(out, name=name, device="cpu")
            if set(loaded) != set(params):
                raise AssertionError(f"{name}: reloaded keys differ from the saved ones")
            for key, value in params.items():
                want = (value.dequantize() if isinstance(value, PalettizedTensor)
                        else value).cpu()
                if not torch.equal(loaded[key], want):
                    raise AssertionError(f"{name}: {key} reloads with other values")
            logger.info("%s artifact verified", name)
        logger.info("%s converted", name)

    def params_of(model):
        """The module's state dict, or its palettized tree."""
        if not args.quantize_nbits:
            return model.state_dict()
        kwargs = {}
        if args.palettize_min_size is not None:
            kwargs["min_size"] = args.palettize_min_size
        tree, stats = palettize_tree(model, args.quantize_nbits, **kwargs)
        logger.info("palettized @%db: %d tensors, payload %.2fx smaller (%.1f MB -> %.1f MB)",
                    args.quantize_nbits, stats["palettized"],
                    stats["orig_bytes"] / max(stats["new_bytes"], 1),
                    stats["orig_bytes"] / 2**20, stats["new_bytes"] / 2**20)
        return tree

    def denoiser_parity(kind, module_dir):
        """Gate the port in float32 (bf16 serving is a precision choice, not
        a porting error) against the diffusers mirror, and count its
        elements against the source's."""
        if not check:
            return
        sd = load.load_safetensors_state_dict(module_dir)
        label = Path(module_dir).name
        if kind == "unet":
            m32 = load.load_unet(module_dir, dtype=torch.float32, device=dev)
            verify.element_count_matches(sd, m32, str(module_dir))
            gates[label] = verify.torch_parity_unet(sd, m32, label=label)
        elif kind == "mmdit":
            m32 = load.load_mmdit(module_dir, dtype=torch.float32, device=dev)
            verify.element_count_matches(sd, m32, str(module_dir))
            gates[label] = verify.torch_parity_mmdit(sd, m32, label=label)
        else:
            m32 = load.load_controlnet(module_dir, dtype=torch.float32, device=dev)
            verify.element_count_matches(sd, m32, str(module_dir))
            if type(m32).__name__ == "SD3ControlNetModel":
                gates[label] = verify.torch_parity_sd3_controlnet(sd, m32, label=label)
            else:
                gates[label] = verify.torch_parity_controlnet(sd, m32, label=label)

    # -- text encoders (palettized too under --quantize-nbits; they load dense)
    if (all_ or args.convert_text_encoder) and not exists("TextEncoder"):
        if (src / "text_encoder").exists():
            model = load.load_text_encoder(src / "text_encoder",
                                           with_projection=True if is_sd3 else None, device=dev)
            if check:
                gates["text_encoder"] = verify.torch_parity_text_encoder(src / "text_encoder",
                                                                         model)
            save("TextEncoder", params_of(model), model.config)
        else:
            logger.info("no text_encoder/ in checkpoint (refiner-only XL)")
    if ((all_ and (is_xl or is_sd3)) or args.convert_text_encoder) \
            and (src / "text_encoder_2").exists() and not exists("TextEncoder2"):
        model = load.load_text_encoder(src / "text_encoder_2", with_projection=True, device=dev)
        if check:
            gates["text_encoder_2"] = verify.torch_parity_text_encoder(src / "text_encoder_2",
                                                                       model)
        save("TextEncoder2", params_of(model), model.config)
    if ((all_ and is_sd3) or args.convert_t5) \
            and (src / "text_encoder_3").exists() and not exists("TextEncoderT5"):
        # float32, as the JAX command stores it; the pipeline loads it in
        # its compute dtype
        model = load.load_t5(src / "text_encoder_3", dtype=torch.float32, device=dev)
        if check:
            gates["text_encoder_3"] = verify.torch_parity_t5(src / "text_encoder_3", model)
        save("TextEncoderT5", model.state_dict(), model.config)

    # -- denoiser
    if is_sd3:
        if (all_ or args.convert_mmdit) and not exists("MMDiT"):
            denoiser_parity("mmdit", src / "transformer")
            model = load.load_mmdit(src / "transformer", device=dev)
            save("MMDiT", params_of(model), model.config)
    elif (all_ or args.convert_unet) and not exists("Unet"):
        denoiser_parity("unet", src / "unet")
        model = load.load_unet(src / "unet", dtype=torch.bfloat16, device=dev)
        save("Unet", params_of(model), model.config)
    if args.refiner_version and not exists("RefinerUnet"):
        denoiser_parity("unet", Path(args.refiner_version) / "unet")
        model = load.load_unet(Path(args.refiner_version) / "unet", dtype=torch.bfloat16,
                               device=dev)
        save("RefinerUnet", params_of(model), model.config)
    model = None  # the denoiser leaves the card before the VAE comes

    # -- VAE
    vae_dir = Path(args.custom_vae) if args.custom_vae else src / "vae"
    if all_ or args.convert_vae_decoder or args.convert_vae_encoder:
        dec, enc = load.load_vae(vae_dir, device=dev)
        if (all_ or args.convert_vae_decoder) and not exists("VAEDecoder"):
            save("VAEDecoder", dec.state_dict(), dec.config)
        if (all_ or args.convert_vae_encoder) and not exists("VAEEncoder"):
            save("VAEEncoder", enc.state_dict(), enc.config)
        if check:
            sd = load.load_safetensors_state_dict(vae_dir)
            dec_n, enc_n = (sum(v.numel() for v in m.state_dict().values()) for m in (dec, enc))
            src_n = sum(v.numel() for v in sd.values())
            if dec_n + enc_n != src_n:
                raise AssertionError(f"VAE port element count {dec_n}+{enc_n} != source {src_n}")
            logger.info("VAE: element count matches source (%d)", src_n)
            gates["vae_decoder"] = verify.torch_parity_vae_decoder(sd, dec, label=vae_dir.name)
            gates["vae_encoder"] = verify.torch_parity_vae_encoder(sd, enc, label=vae_dir.name)
        del dec, enc

    # -- safety checker
    if (all_ or args.convert_safety_checker) \
            and (src / "safety_checker" / "config.json").exists() \
            and not exists("SafetyChecker"):
        model = load.load_safety_checker(src / "safety_checker", device=dev)
        if check:
            gates["safety_checker"] = verify.torch_parity_safety(src / "safety_checker", model)
        save("SafetyChecker", model.state_dict(), model.config)

    # -- controlnets
    for cn_dir in args.convert_controlnet:
        cn_dir = Path(cn_dir)
        name = f"ControlNet-{cn_dir.name}"
        if exists(name):
            continue
        denoiser_parity("controlnet", cn_dir)
        model = load.load_controlnet(cn_dir, device=dev)
        save(name, params_of(model), model.config)

    if args.convert_multilingual_projection:
        from ..models.multilingual import port_multilingual_projection

        sd = torch.load(args.convert_multilingual_projection, map_location="cpu",
                        weights_only=True)
        artifacts.save_module(out, port_multilingual_projection(sd),
                              name="MultilingualTextEncoderProjection")
        logger.info("MultilingualTextEncoderProjection converted")

    # -- bundle
    if args.bundle_resources_for_generation:
        for tok_name, dest in (("tokenizer", out), ("tokenizer_2", out / "tokenizer_2")):
            tok = src / tok_name
            if not tok.exists():
                continue
            dest.mkdir(parents=True, exist_ok=True)
            for f in ("vocab.json", "merges.txt"):
                if (tok / f).exists():
                    shutil.copy(tok / f, dest / f)
        if (src / "tokenizer_3" / "tokenizer.json").exists():
            (out / "tokenizer_3").mkdir(exist_ok=True)
            shutil.copy(src / "tokenizer_3" / "tokenizer.json",
                        out / "tokenizer_3" / "tokenizer.json")
        index_file = src / "model_index.json"
        index = json.loads(index_file.read_text()) if index_file.exists() else {}
        sched_file = src / "scheduler" / "scheduler_config.json"
        bundle = {
            "family": family,
            "scheduler": json.loads(sched_file.read_text()) if sched_file.exists() else None,
            "force_zeros_for_empty_prompt": index.get("force_zeros_for_empty_prompt", True),
            "controlnets": [f"ControlNet-{Path(d).name}" for d in args.convert_controlnet],
        }
        (out / "bundle.json").write_text(json.dumps(bundle, indent=1))
        logger.info("resources bundled (bundle.json, tokenizers, scheduler)")
    return {"psnr_db": gates}


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    run(parser_spec().parse_args(argv))


if __name__ == "__main__":
    main()
