"""Helpers shared by the tests of the PyTorch port: numpy is the carrier
between the two frameworks."""
import jax
import jax.numpy as jnp
import numpy as np
import torch


def to_jax(a: np.ndarray, dtype=None):
    x = jnp.asarray(a)
    return x.astype(dtype) if dtype is not None else x


def to_torch(a: np.ndarray, dtype=None) -> torch.Tensor:
    t = torch.from_numpy(np.array(a, copy=True))
    return t.to(dtype) if dtype is not None else t


def np32(x) -> np.ndarray:
    """A jax array or a torch tensor (any float dtype) as float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy() if x.is_floating_point() else x.cpu().numpy()
    return np.asarray(x.astype(jnp.float32) if jnp.issubdtype(x.dtype, jnp.floating) else x)


def jax_tree_to_numpy(tree):
    """JAX parameter tree -> nested dict of numpy arrays (bf16 as float32)."""
    return jax.tree_util.tree_map(np32, tree)
