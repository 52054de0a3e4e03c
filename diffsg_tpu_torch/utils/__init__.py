from .checkpoint import load_checkpoint, save_checkpoint
from .metrics import MetricsLogger, write_csv
from .params import params_from_jax, params_to_jax, tree_from_state
from .torch_export import ddpm_to_torch, unet_params_to_torch
from .torch_import import (ddpm_from_torch, load_torch_state_dict, sequential_mlp_from_torch,
                           unet_state_from_torch)

#: The JAX package's name for :func:`unet_state_from_torch` (there it returns
#: a flax tree, here a module state dict).
unet_params_from_torch = unet_state_from_torch
