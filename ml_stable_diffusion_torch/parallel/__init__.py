"""Training and multi-card inference over ``torch.distributed``, one process
per card: the DDPM epsilon-MSE step (``train.py``) and its checkpoint
(``checkpoint.py``); the (dp, tp) mesh (``mesh.py``), the tensor-parallel
rules (``sharding.py``), the sharded layers that carry them out
(``layers.py``), and the tensor- and spatial-sharded forwards
(``inference.py``).  The training step's tp axis is not ported."""

from .checkpoint import restore_train_state, save_train_state
from .inference import make_spatial_sharded_forward, make_tensor_sharded_forward
from .mesh import make_mesh
from .sharding import batch_sharding, param_sharding_rules, shard_params
from .train import TrainState, adamw, epsilon_mse, make_train_step, sgd

__all__ = ["TrainState", "adamw", "batch_sharding", "epsilon_mse", "make_mesh",
           "make_spatial_sharded_forward", "make_tensor_sharded_forward", "make_train_step",
           "param_sharding_rules", "restore_train_state", "save_train_state", "sgd",
           "shard_params"]
