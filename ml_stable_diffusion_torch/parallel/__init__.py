"""Training on one card or data-parallel over a ``torch.distributed`` group:
the DDPM epsilon-MSE step (``train.py``) and its checkpoint
(``checkpoint.py``).  The JAX package's tensor and spatial sharding
(``parallel/mesh.py``, ``sharding.py``, ``inference.py``) is not ported."""

from .checkpoint import restore_train_state, save_train_state
from .train import TrainState, adamw, epsilon_mse, make_train_step, sgd

__all__ = ["TrainState", "adamw", "epsilon_mse", "make_train_step", "restore_train_state",
           "save_train_state", "sgd"]
