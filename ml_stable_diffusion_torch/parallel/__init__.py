"""Training and multi-card inference over ``torch.distributed``, one process
per card: the DDPM epsilon-MSE step over a (dp, tp) mesh (``train.py``) and
its global checkpoint (``checkpoint.py``); the (dp, tp) mesh (``mesh.py``),
the tensor-parallel rules (``sharding.py``), the sharded layers that carry
them out, forward and backward (``layers.py``), and the tensor- and
spatial-sharded forwards (``inference.py``)."""

from .checkpoint import restore_train_state, save_train_state
from .inference import make_spatial_sharded_forward, make_tensor_sharded_forward
from .mesh import make_mesh
from .sharding import batch_sharding, param_sharding_rules, shard_params
from .train import TrainState, adamw, epsilon_mse, full_state_dict, make_train_step, sgd

__all__ = ["TrainState", "adamw", "batch_sharding", "epsilon_mse", "full_state_dict",
           "make_mesh", "make_spatial_sharded_forward", "make_tensor_sharded_forward",
           "make_train_step", "param_sharding_rules", "restore_train_state",
           "save_train_state", "sgd", "shard_params"]
