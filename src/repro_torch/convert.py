"""Carry weights and state across from the JAX package's layout.

The JAX package keeps parameters as nested dicts/lists of arrays with HWIO
convolution kernels. Given those arrays as numpy (``np.asarray`` of each
leaf), these functions build the port's counterparts, so a test can start
both packages from the same carry. Nothing here imports the JAX package.

  * ``named_from_tree``   — nested tree -> {"stages.0.0.conv1": array, ...} in
                            the port's layout (convolutions HWIO -> OIHW; the
                            head stays a [D, classes] matrix);
  * ``cnn_params_from_jax`` — load such a tree into a fresh ``CNN``;
  * ``buffer_from_jax`` / ``opt_state_from_jax`` — the buffer and optimizer
                            state of a carry.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.buffer.state import BufferState
from repro_torch.models.resnet import init_cnn
from repro_torch.optim.optimizers import OptState


def _walk(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], np.asarray(tree)


def named_from_tree(tree) -> Dict[str, np.ndarray]:
    """Flatten a JAX CNN parameter-shaped tree into the port's names/layout."""
    out = {}
    for name, a in _walk(tree):
        out[name] = np.ascontiguousarray(a.transpose(3, 2, 0, 1)) if a.ndim == 4 else a
    return out


def cnn_params_from_jax(np_tree, cfg, device="cpu"):
    """A ``CNN`` holding the weights of the JAX ``init_cnn`` tree ``np_tree``."""
    model = init_cnn(torch.Generator().manual_seed(0), cfg, device)
    named = named_from_tree(np_tree)
    params = dict(model.named_parameters())
    if set(named) != set(params):
        raise ValueError(f"parameter names differ: {sorted(set(named) ^ set(params))}")
    with torch.no_grad():
        for name, p in params.items():
            if tuple(named[name].shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {named[name].shape} != {tuple(p.shape)}")
            p.copy_(torch.from_numpy(np.array(named[name], dtype=np.float32)))
    return model


def buffer_from_jax(state, device="cpu") -> BufferState:
    """A port ``BufferState`` from a JAX ``BufferState`` (flat, reservoir)."""
    data = {k: torch.from_numpy(np.array(v)).to(device) for k, v in state.data.items()}
    counts = torch.from_numpy(np.array(state.counts, dtype=np.int32)).to(device)
    seen = torch.from_numpy(np.array(state.seen, dtype=np.int32)).to(device)
    return BufferState(data, counts, seen)


def opt_state_from_jax(opt, device="cpu") -> OptState:
    """A port ``OptState`` from a JAX SGD ``OptState`` (step, momentum tree)."""
    def tensors(tree):
        return {k: torch.from_numpy(np.array(v, dtype=np.float32)).to(device)
                for k, v in named_from_tree(tree).items()}

    return OptState(int(np.asarray(opt.step)), tensors(opt.mu))
