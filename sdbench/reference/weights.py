"""Random weights from the seed, the same for the program and the reference.

Variance-preserving weights: N(0, 1/fan_in) for every matrix, kernel and
embedding table; 1 + N(0, 0.1^2) for norm scales (the one-dimensional
``weight``s) and N(0, 0.1^2) for every bias (Linear, Conv2d and norm
shifts).  Weights of this kind keep the activations of every layer near
unit scale, so attention is far from uniform and a fault or a lower
precision shows in the outputs (N(0, 0.02) weights would make attention
nearly uniform); and since no scale is 1 and no bias 0, a layer that drops
its bias or ignores a norm's scale or shift gives other images.

The draws are made on the module's device from one ``torch.Generator``
seeded by (seed, tag), in a few large calls: the matrices, sorted by name,
are cut into chunks of up to ``CHUNK`` elements drawn at once, and then
the one-dimensional parameters, sorted by name, are drawn in one call.
The chunking follows the sorted names and shapes alone, so two modules with the same
parameter names and shapes receive the same values, whatever their classes
and dtypes.  A parameter held in a lower dtype receives the draw rounded to
it; the reference passes ``round_to`` to hold the same rounded values in
float32.
"""

from __future__ import annotations

import hashlib
import math

import torch

CHUNK = 1 << 26
#: the spread of norm scales around 1 and of biases around 0
VECTOR_STD = 0.1


def generator(seed: int, tag: str, device) -> torch.Generator:
    digest = hashlib.sha256(f"{int(seed)}/{tag}".encode()).digest()
    return torch.Generator(device=device).manual_seed(int.from_bytes(digest[:8], "little") >> 1)


def spec(module: torch.nn.Module) -> list[tuple[str, tuple[int, ...]]]:
    """(name, shape) of every parameter, sorted by name."""
    return sorted((n, tuple(p.shape)) for n, p in module.named_parameters())


@torch.no_grad()
def fill_(module: torch.nn.Module, seed: int, tag: str, round_to: torch.dtype | None = None):
    """Give every parameter of ``module`` (already on its device, any dtype)
    its value from (seed, tag)."""
    params = dict(module.named_parameters())
    device = next(iter(params.values())).device
    gen = generator(seed, tag, device)
    matrices, vectors = [], []
    for name, shape in spec(module):
        (matrices if len(shape) >= 2 else vectors).append((name, params[name]))
    i = 0
    while i < len(matrices):
        group, n = [matrices[i]], matrices[i][1].numel()
        i += 1
        while i < len(matrices) and n + matrices[i][1].numel() <= CHUNK:
            group.append(matrices[i])
            n += matrices[i][1].numel()
            i += 1
        flat = torch.randn(n, generator=gen, device=device, dtype=torch.float32)
        off = 0
        for _, p in group:
            k = p.numel()
            _put(p, flat[off:off + k].view(p.shape) * (1.0 / math.sqrt(p[0].numel())), round_to)
            off += k
        del flat
    if vectors:
        flat = torch.randn(sum(p.numel() for _, p in vectors), generator=gen, device=device,
                           dtype=torch.float32) * VECTOR_STD
        off = 0
        for name, p in vectors:
            k = p.numel()
            v = flat[off:off + k]
            _put(p, v + 1.0 if name.endswith("weight") else v, round_to)
            off += k
    return module


def _put(p: torch.Tensor, v: torch.Tensor, round_to):
    p.copy_(v.to(round_to) if round_to is not None else v)
