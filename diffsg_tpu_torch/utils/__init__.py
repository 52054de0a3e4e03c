from .checkpoint import load_checkpoint
from .params import params_from_jax
