from .checkpoint import load_checkpoint, save_checkpoint
from .params import params_from_jax, params_to_jax, tree_from_state
