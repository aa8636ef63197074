"""CLIP score: image-prompt cosine similarity (port of
ml_stable_diffusion_tpu/utils/clip_score.py).

The prompt through a CLIP text tower, the image through a CLIP vision tower
(the safety checker's ViT and projection), the cosine of their embeddings:
the opt-in quality gate of the benchmark command, with the reference's
threshold of 0.3.  The image is resized to the tower's size by
``models/safety.py:resize_uint8``, the port's stand-in for PIL's BICUBIC
resize (within one uint8 level of it).

The score means something only in CLIP's joint space: the text tower must
carry a ``text_projection`` (``use_text_projection=True``) into the vision
tower's ``projection_dim``.  SD 1.x's bundled text encoder has none, and its
768-wide pooled state happens to match the safety checker's joint width, so
the guard reads the config before it checks the widths.
"""

from __future__ import annotations

import numpy as np
import torch

#: the reference's quality gate
MINIMUM_CLIP_SCORE = 0.3


@torch.no_grad()
def clip_score(text_encoder, vision_model, tokenizer, prompt: str, image) -> float:
    """cosine(text embedding, image embedding) in [-1, 1]: ``text_encoder``
    a ``CLIPTextEncoder``, ``vision_model`` a ``SafetyChecker``, ``image``
    (H, W, 3) uint8."""
    from ..models.safety import resize_uint8

    if not getattr(text_encoder.config, "use_text_projection", False):
        raise ValueError(
            "clip_score requires a text encoder WITH text_projection "
            "(use_text_projection=True) so the pooled output lands in the "
            "CLIP joint space; this encoder pools the raw EOS hidden state "
            "(SD1.x-style). Point --clip-checkpoint at a full CLIP bundle "
            "whose text_encoder carries a text_projection into the safety "
            "checker's projection_dim.")
    device = next(text_encoder.parameters()).device
    ids, _ = tokenizer.tokenize(prompt)
    ids = torch.from_numpy(np.asarray(ids, np.int64)[None]).to(device)
    temb = text_encoder(ids)["pooled_output"][0].double().cpu().numpy()
    temb /= np.linalg.norm(temb) + 1e-8

    vdev = next(vision_model.parameters()).device
    img = torch.from_numpy(np.ascontiguousarray(np.asarray(image, np.uint8))[None]).to(vdev)
    x = resize_uint8(img, vision_model.config.image_size)
    vemb = vision_model(x)["image_embeds"].double().cpu().numpy().reshape(-1)
    vemb /= np.linalg.norm(vemb) + 1e-8
    if temb.shape != vemb.shape:
        raise ValueError(
            f"text embedding dim {temb.shape[0]} != image embedding dim "
            f"{vemb.shape[0]}: the text tower does not project into the "
            "vision tower's joint space — point --clip-checkpoint at a "
            "bundle whose text encoder carries a text_projection into the "
            "safety checker's projection_dim")
    return float(temb @ vemb)
