"""The port's package exports against the JAX package's: every name that a
``diffsg_tpu/<sub>/__init__.py`` binds (its imports and assignments) is an
attribute of the matching ``diffsg_tpu_torch`` subpackage, so a JAX script
with the package name swapped imports. The one exception is the JAX-only
``train.build_train_epoch`` (the port's trainer builds no compiled epoch).
Also ``linear_beta_schedule`` against JAX's."""

import ast
import importlib
import pathlib

import numpy as np
import pytest

from diffsg_tpu.diffusion import linear_beta_schedule as jax_linear_beta_schedule
from diffsg_tpu_torch.diffusion import linear_beta_schedule
from diffsg_tpu_torch.utils import unet_params_from_torch, unet_state_from_torch

REPO = pathlib.Path(__file__).resolve().parent.parent
JAX_ONLY = {"train": {"build_train_epoch"}}
SUBPACKAGES = sorted(p.parent.name for p in (REPO / "diffsg_tpu").glob("*/__init__.py"))


def bound_names(init: pathlib.Path):
    """The names an ``__init__.py`` binds at module level."""
    names = set()
    for node in ast.parse(init.read_text()).body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0] for a in node.names)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets if isinstance(t, ast.Name))
    return names


def test_every_jax_subpackage_has_a_port():
    assert SUBPACKAGES == ["baselines", "data", "diffusion", "models", "ops", "parallel",
                           "tasks", "train", "utils"]


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_port_exports_the_jax_names(sub):
    want = bound_names(REPO / "diffsg_tpu" / sub / "__init__.py") - JAX_ONLY.get(sub, set())
    port = importlib.import_module(f"diffsg_tpu_torch.{sub}")
    assert sorted(n for n in want if not hasattr(port, n)) == []
    # and imported by the port's own __init__, not only reachable as a submodule
    assert want <= bound_names(REPO / "diffsg_tpu_torch" / sub / "__init__.py")


@pytest.mark.parametrize("T,low,high", [(1000, 1e-4, 0.02), (20, 1e-4, 0.02), (7, 0.001, 0.5),
                                        (1, 0.1, 0.2)])
def test_linear_beta_schedule_equals_jax(T, low, high):
    got, want = linear_beta_schedule(T, low, high), jax_linear_beta_schedule(T, low, high)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)


def test_unet_params_from_torch_is_the_state_converter():
    assert unet_params_from_torch is unet_state_from_torch
