"""Save and resume a training state (port of
ml_stable_diffusion_tpu/parallel/checkpoint.py, which uses orbax).

A state is three torch files in one directory: the parameters
(``params.pt``), the optimizer's ``state_dict`` (``opt_state.pt``) and the
step (``step.pt``).  They load with ``weights_only=True``: tensors and plain
containers, no pickled code.
"""

from __future__ import annotations

from pathlib import Path

import torch

from .train import TrainState


def save_train_state(directory: str | Path, state: TrainState):
    d = Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    torch.save(state.model.state_dict(), d / "params.pt")
    torch.save(state.optimizer.state_dict(), d / "opt_state.pt")
    torch.save(torch.tensor(state.step), d / "step.pt")


def restore_train_state(directory: str | Path, template: TrainState) -> TrainState:
    """Load a saved state into ``template`` (from the same ``init_fn``) and
    return it: parameters on the template's device, the optimizer's moments
    read from the mapped file into its parameters' devices by
    ``load_state_dict`` and its step counters kept on the host, as a live
    optimizer keeps them."""
    d = Path(directory)
    device = next(template.model.parameters()).device
    template.model.load_state_dict(
        torch.load(d / "params.pt", map_location=device, weights_only=True), strict=True)
    template.optimizer.load_state_dict(
        torch.load(d / "opt_state.pt", map_location="cpu", weights_only=True, mmap=True))
    template.step = int(torch.load(d / "step.pt", weights_only=True))
    return template
