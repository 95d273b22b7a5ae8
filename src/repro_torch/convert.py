"""Carry weights and state across from the JAX package's layout.

The JAX package keeps parameters as nested dicts/lists of arrays with HWIO
convolution kernels. Given those arrays as numpy (``np.asarray`` of each
leaf), these functions build the port's counterparts, so a test can start
both packages from the same carry. Nothing here imports the JAX package.

  * ``named_from_tree``   — nested tree -> {"stages.0.0.conv1": array, ...} in
                            the port's layout (convolutions HWIO -> OIHW; the
                            head stays a [D, classes] matrix);
  * ``cnn_params_from_jax`` — load such a tree into a fresh ``CNN``;
  * ``lm_params_from_jax``  — the JAX ``init_decoder`` tree (dense, SSM,
                            MoE, hybrid or VLM) into a fresh ``Decoder``, its
                            stacked ``units.layer{i}.*`` leaves (``moe.*``
                            among them) split into
                            ``layers.{u * period + i}.*``
                            (``lm_named_from_tree``, which also names a
                            gradient or moment tree of that shape);
                            ``load_named`` loads any module from
                            ``{name: array}``;
  * ``encdec_params_from_jax`` — the JAX ``init_encdec`` tree into a fresh
                            ``EncDec``, its stacked ``enc_layers.*`` and
                            ``dec_layers.*`` leaves split into
                            ``enc_layers.{i}.*`` / ``dec_layers.{i}.*``
                            (``encdec_named_from_tree``, which also names a
                            gradient tree of that shape);
  * on a model axis (``mp``, a ``parallel.ModelParallel``) the LM
    functions take the JAX package's FULL trees and keep this rank's shards
    (``parallel.sharding.shard_param`` under the rule table);
  * ``buffer_from_jax`` / ``tiered_from_jax`` / ``opt_state_from_jax`` /
    ``ef_from_jax``       — the flat or tiered buffer (every record leaf,
                            a tap strategy's too, and the policy's aux), the
                            optimizer state (SGD's momentum, or AdamW's two
                            moments, of a CNN or an LM) and the int8 error
                            feedback of a carry.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.buffer.state import BufferState, tree_map
from repro_torch.buffer.tiered import TieredState, resolve_cold_placement
from repro_torch.device import resolve_device
from repro_torch.models.resnet import init_cnn
from repro_torch.models.transformer import init_decoder, init_encdec, unit_period
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


def cnn_params_from_jax(np_tree, cfg, device=None):
    """A ``CNN`` holding the weights of the JAX ``init_cnn`` tree ``np_tree``,
    on ``device`` (the card unless the caller asks for the CPU)."""
    return load_named(init_cnn(torch.Generator().manual_seed(0), cfg, device),
                      named_from_tree(np_tree))


def load_named(module: torch.nn.Module, named: Dict[str, np.ndarray]) -> torch.nn.Module:
    """Copy ``named`` arrays into ``module``'s parameters of the same names,
    after checking that the names and shapes match exactly."""
    params = dict(module.named_parameters())
    if set(named) != set(params):
        raise ValueError(f"parameter names differ: {sorted(set(named) ^ set(params))}")
    with torch.no_grad():
        for name, p in params.items():
            if tuple(named[name].shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {named[name].shape} != {tuple(p.shape)}")
            p.copy_(torch.from_numpy(np.array(named[name], dtype=np.float32)))
    return module


def lm_named_from_tree(tree, cfg, mp=None) -> Dict[str, np.ndarray]:
    """Flatten a JAX ``init_decoder``-shaped tree (parameters, gradients or
    optimizer moments) into the ``Decoder``'s parameter names: the stacked
    ``units.layer{i}.*`` leaves split into ``layers.{u * period + i}.*``;
    with ``mp``, each cut to this rank's shard."""
    return _shard_named(_lm_named(tree, cfg), cfg, mp)


def _shard_named(named: Dict[str, np.ndarray], cfg, mp) -> Dict[str, np.ndarray]:
    """``named`` (whole arrays), each cut to the rank's shard of ``mp``
    (None: as they are)."""
    if mp is None:
        return named
    from repro_torch.parallel.sharding import param_spec, shard_param

    return {k: np.ascontiguousarray(shard_param(a, param_spec(k, a.shape, cfg, mp.size), mp))
            for k, a in named.items()}


def _lm_named(tree, cfg) -> Dict[str, np.ndarray]:
    period = unit_period(cfg)
    named = {}
    for name, a in _walk(tree):
        if name.startswith("units."):
            _, unit_layer, rest = name.split(".", 2)
            i = int(unit_layer[len("layer"):])
            for u in range(a.shape[0]):
                named[f"layers.{u * period + i}.{rest}"] = a[u]
        else:
            named[name] = a
    return named


def lm_params_from_jax(np_tree, cfg, device=None, mp=None):
    """A ``Decoder`` holding the weights of the JAX ``init_decoder`` tree
    ``np_tree`` (dense, SSM, MoE or hybrid), on ``device`` (the card unless
    the caller asks for the CPU); with ``mp``, this rank's shards of them.
    Dense weights keep their ``[d_in, d_out]`` layout, the experts' theirs
    (``[E, d, f]``, ``[E, f, d]``). An enc-dec tree gives an ``EncDec``
    (``encdec_params_from_jax``)."""
    if cfg.family == "encdec":
        return encdec_params_from_jax(np_tree, cfg, device, mp)
    model = init_decoder(torch.Generator().manual_seed(0), cfg, 1, device, mp)
    return load_named(model, lm_named_from_tree(np_tree, cfg, mp))


def encdec_named_from_tree(tree) -> Dict[str, np.ndarray]:
    """Flatten a JAX ``init_encdec``-shaped tree (parameters or gradients)
    into the ``EncDec``'s parameter names: the stacked ``enc_layers.*`` and
    ``dec_layers.*`` leaves split into ``enc_layers.{i}.*`` and
    ``dec_layers.{i}.*``."""
    named = {}
    for name, a in _walk(tree):
        stack, _, rest = name.partition(".")
        if stack in ("enc_layers", "dec_layers"):
            for i in range(a.shape[0]):
                named[f"{stack}.{i}.{rest}"] = a[i]
        else:
            named[name] = a
    return named


def encdec_params_from_jax(np_tree, cfg, device=None, mp=None):
    """An ``EncDec`` holding the weights of the JAX ``init_encdec`` tree
    ``np_tree`` (its positions as long as the tree's), on ``device`` (the
    card unless the caller asks for the CPU); with ``mp``, this rank's
    shards of them."""
    max_seq = np.shape(np_tree["enc_pos"]["pos"])[0]
    model = init_encdec(torch.Generator().manual_seed(0), cfg, max_seq, device, mp)
    return load_named(model, _shard_named(encdec_named_from_tree(np_tree), cfg, mp))


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).to(device)


def buffer_from_jax(state, device=None, *, pin_data: bool = False) -> BufferState:
    """A port ``BufferState`` from a JAX ``BufferState`` (the data may be a
    dict of dicts, as the cold tier's; the policy's aux a dict of arrays, as
    FIFO's ``cursor`` or GRASP's ``proto``/``proto_n``/``dist``, or ``()``)
    on ``device``, the card unless the caller asks for the CPU. ``pin_data``
    puts the data leaves in pinned host memory, the counts and aux on
    ``device``."""
    device = resolve_device(device)

    def leaf(a):
        return torch.from_numpy(np.array(a)).pin_memory() if pin_data else _tensor(a, device)

    data = tree_map(leaf, dict(state.data))
    counts = _tensor(np.asarray(state.counts, dtype=np.int32), device)
    seen = _tensor(np.asarray(state.seen, dtype=np.int32), device)
    aux = state.aux
    if isinstance(aux, dict):
        aux = {k: _tensor(v, device) for k, v in aux.items()}
    return BufferState(data, counts, seen, aux)


def tiered_from_jax(state, device=None) -> TieredState:
    """A port ``TieredState`` from a JAX ``TieredState``: the hot tier (with
    its policy aux) and the stage on ``device`` (the card unless the caller
    asks for the CPU), the cold tier's ``{"q", "scale"}`` / ``{"raw"}``
    leaves where ``resolve_cold_placement`` puts them."""
    device = resolve_device(device)
    pinned = resolve_cold_placement(device) == "pinned_host"
    return TieredState(buffer_from_jax(state.hot, device),
                       buffer_from_jax(state.cold, device, pin_data=pinned),
                       {k: _tensor(v, device) for k, v in state.stage.items()},
                       _tensor(state.stage_labels, device),
                       _tensor(state.stage_valid, device))


def opt_state_from_jax(opt, device=None, lm_cfg=None, mp=None) -> OptState:
    """A port ``OptState`` from a JAX ``OptState`` on ``device``, the card
    unless the caller asks for the CPU: the integer step, the first moment,
    and AdamW's second moment (SGD's ``nu``, a tree of scalar zeros, becomes
    the port's empty dict). The trees are named as a CNN's, or as a
    ``Decoder``'s when ``lm_cfg`` gives the LM's config (``mp``: this rank's
    shards of the moments)."""
    device = resolve_device(device)

    def tensors(tree):
        named = (named_from_tree(tree) if lm_cfg is None
                 else lm_named_from_tree(tree, lm_cfg, mp))
        return {k: torch.from_numpy(np.array(v, dtype=np.float32)).to(device)
                for k, v in named.items()}

    sgd = all(a.ndim == 0 for _, a in _walk(opt.nu))
    return OptState(int(np.asarray(opt.step)), tensors(opt.mu), {} if sgd else tensors(opt.nu))


def ef_from_jax(ef, device=None) -> Dict[str, torch.Tensor]:
    """The port's error feedback ``{name: f32}`` from the JAX
    ``init_error_feedback`` tree (the parameters' layout) on ``device``, the
    card unless the caller asks for the CPU."""
    device = resolve_device(device)
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)).to(device)
            for k, v in named_from_tree(ef).items()}
