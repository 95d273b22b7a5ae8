"""Step gauges: the ``obs/*`` entries a step adds to its metrics.

``step_metrics`` returns a flat ``{"obs/...": value}`` dict that the step
factories (``strategy/step.py``, ``launch/steps.py``) merge into their
metrics when ``ObsConfig`` is on. Every value is a pure read of state the
step already has:

* no generator is drawn from, so the ``rep_checksum``/``buffer_fill``/loss
  fingerprints are bit-identical with the gauges on or off;
* no state is added to the carry (checkpoints and reshards are unchanged);
* the values are f32 scalars on the step's device, or host floats for the
  constants (``rep_staleness``, ``aux_row_bytes``), and no gauge reads a
  value back: ``read_gauges`` copies all of a step's tensors to the host in
  one stacked copy, on the steps whose metrics are kept.

``obs/grad_norm`` is the global norm of the gradients the optimizer takes
(summed over the group), the one the optimizer already computes for its
clip: the gauge adds no kernel. ``obs/param_norm`` is the norm of the
per-tensor norms (``tree_l2``).

On a mesh (``group``), the buffer and replay gauges are the global store's,
as the reference reads them off its ``[N_dp, K]`` state: each rank's
additive parts (the per-bucket records, the fills and counters, the valid
representatives) travel in one ``all_reduce`` of one flat vector, and the
minima, maxima and ratios are taken of the sums. The carry backend's group
step means its metrics over the group, as the reference's ``pmean`` does.

``obs_keys`` and ``estimate_obs_cost`` are the static half: the keys a
configuration emits, and their bytes.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist

PREFIX = "obs/"

# The one-step-stale double buffer fixes the representatives' staleness at 1
# for the pipelined step and 0 for the sync one. The extra staleness of a
# straggler's reuse is an event (StragglerPolicy's stale_dispatch).
STALENESS_PIPELINED = 1.0
STALENESS_SYNC = 0.0


@torch.no_grad()
def tree_l2(tensors) -> torch.Tensor:
    """Global L2 norm (f32) of the floating-point tensors of ``tensors``
    (an iterable, or a module's parameters): the norm of their norms, the
    per-tensor norms in one multi-tensor call (a few launches on a card
    for the 161 tensors of a ResNet-50)."""
    if isinstance(tensors, torch.nn.Module):
        tensors = tensors.parameters()
    floats = [t if t.dtype == torch.float32 else t.float() for t in tensors
              if t.is_floating_point()]
    if not floats:
        return torch.zeros(())
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(floats)))


@torch.no_grad()
def _model_l2(module, mp) -> torch.Tensor:
    from repro_torch.parallel.tensor import model_sq_norm

    named = {k: p for k, p in module.named_parameters() if p.is_floating_point()}
    return torch.sqrt(model_sq_norm(named, getattr(module, "tp_sharded", ()), mp))


def replay_metrics(valid, new_rows: int) -> Dict[str, torch.Tensor]:
    """The replay's share of one augmented batch: ``valid`` masks the
    consumed representatives, ``new_rows`` counts the incoming rows.
    Invalid representatives are masked out of the loss, so the rows trained
    on are ``new_rows + sum(valid)``."""
    return _replay_from(valid.float().sum(), new_rows)


def _replay_from(nv: torch.Tensor, new_rows: int) -> Dict[str, torch.Tensor]:
    return {PREFIX + "reps_valid": nv, PREFIX + "replay_fraction": nv / (nv + float(new_rows))}


def _sum_over(parts: Dict[str, torch.Tensor], group) -> Dict[str, torch.Tensor]:
    """``parts`` summed over ``group`` in one all_reduce of one flat vector."""
    keys = sorted(parts)
    flat = torch.cat([parts[k].reshape(-1) for k in keys])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    sizes = [parts[k].numel() for k in keys]
    return {k: v.view_as(parts[k]) for k, v in zip(keys, torch.split(flat, sizes))}


def step_metrics(
    *,
    buffer=None,
    rcfg=None,
    valid=None,
    new_rows: Optional[int] = None,
    grad_norm=None,
    params=None,
    staleness: Optional[float] = None,
    aux_bytes: Optional[int] = None,
    cfg=None,
    group=None,
    mp=None,
) -> Dict[str, Any]:
    """The gauges of one step, from what the step has in hand. Every
    argument is optional: the keys of what is passed appear. ``grad_norm``
    is the optimizer's global gradient norm, ``params`` the model after the
    update; ``cfg`` (an ``ObsConfig``) gates those two gauges. ``group`` (a
    mesh's data group of more than one rank) makes the buffer and replay
    gauges global sums, ``new_rows`` then being the global batch's rows.
    ``mp`` (a model row) makes ``param_norm`` the whole model's, the squares
    of ``params.tp_sharded`` summed over the row. Under ZeRO-1 the
    optimizer's norm already sums its slices over the data ranks, each
    rank holds the parameters whole after the step's all-gather, and no
    gauge reads the moments, which a rank holds only its slices of.
    Call only with the gauges on: the factories guard, so that a step with
    them off launches what it launched before."""
    from repro_torch.buffer import api as buffer_api

    parts: Dict[str, torch.Tensor] = {}
    if buffer is not None:
        parts.update(buffer_api.buffer_obs_parts(buffer, rcfg))
    if valid is not None and new_rows is not None:
        parts["reps_valid"] = valid.float().sum()
    if parts and group is not None and dist.get_world_size(group) > 1:
        parts = _sum_over(parts, group)
    out: Dict[str, Any] = {}
    if buffer is not None:
        out.update(buffer_api.obs_from_parts(parts, rcfg))
    if "reps_valid" in parts:
        out.update(_replay_from(parts["reps_valid"], new_rows))
    if staleness is not None:
        out[PREFIX + "rep_staleness"] = float(staleness)
    if aux_bytes is not None:
        out[PREFIX + "aux_row_bytes"] = float(aux_bytes)
    if cfg is None or cfg.grad_norms:
        if grad_norm is not None:
            out[PREFIX + "grad_norm"] = grad_norm
        if params is not None:
            out[PREFIX + "param_norm"] = tree_l2(params) if mp is None else _model_l2(params, mp)
    return out


def grad_norm_of(opt_metrics, grads) -> torch.Tensor:
    """The global norm of the gradients an optimizer step took: the one the
    port's optimizers compute for their clip (``opt_metrics["grad_norm"]``),
    else computed from ``grads`` (a dict of tensors)."""
    norm = opt_metrics.get("grad_norm")
    return norm if isinstance(norm, torch.Tensor) else tree_l2(grads.values())


def gauges_on(cfg) -> bool:
    """Whether an ``ObsConfig`` asks the step for its gauges."""
    return cfg is not None and cfg.enabled and cfg.step_metrics


def read_gauges(metrics) -> Dict[str, float]:
    """The ``obs/*`` entries of a step's metrics as host floats: every
    tensor among them in one stacked copy (one read of the card), the host
    values as they are."""
    keys = sorted(k for k in metrics if k.startswith(PREFIX))
    on_device = [k for k in keys if isinstance(metrics[k], torch.Tensor)]
    out = {k: float(metrics[k]) for k in keys if k not in on_device}
    if on_device:
        vec = torch.stack([metrics[k].detach().float().reshape(()) for k in on_device])
        out.update(zip(on_device, vec.tolist()))
    return out


def host_metrics(metrics) -> Dict[str, float]:
    """Every entry of a step's metrics as a host float; the gauges in one
    copy (``read_gauges``)."""
    out = {k: float(v) for k, v in metrics.items() if not k.startswith(PREFIX)}
    out.update(read_gauges(metrics))
    return out


def aux_row_bytes(aux_spec) -> int:
    """Bytes of ONE record's strategy fields (0 for none): ``aux_spec``
    maps names to ``ItemSpec``s."""
    total = 0
    for spec in (aux_spec or {}).values():
        n = 1
        for s in spec.shape:
            n *= int(s)
        total += n * torch.tensor([], dtype=spec.dtype).element_size()
    return total


# ---------------------------------------------------------------------------
# Static enumeration: the keys a configuration emits, and their bytes
# ---------------------------------------------------------------------------


def obs_keys(rcfg=None, *, grad_norms: bool = True, has_aux: bool = False,
             policy: Optional[str] = None) -> List[str]:
    """The ``obs/*`` keys of a fused step with this configuration, sorted."""
    keys = []
    if grad_norms:
        keys += ["grad_norm", "param_norm"]
    if rcfg is not None and getattr(rcfg, "enabled", False):
        keys += ["fill", "bucket_fill_min", "bucket_fill_max", "evictions", "reps_valid",
                 "replay_fraction", "rep_staleness"]
        if getattr(rcfg, "tiered", False):
            keys += ["hot_fill", "cold_fill", "demotions", "stage_pending"]
        if (policy or getattr(rcfg, "policy", None)) == "grasp":
            keys += ["grasp_mean_dist"]
        if has_aux:
            keys += ["aux_row_bytes"]
    return sorted(PREFIX + k for k in keys)


def estimate_obs_cost(rcfg=None, *, grad_norms: bool = True, has_aux: bool = False,
                      policy: Optional[str] = None) -> Dict[str, Any]:
    """The gauges' cost by count: one f32 scalar a key on the device (4
    bytes), about 56 bytes of host memory as a Python float in a history
    entry, and about 24 bytes of JSON."""
    keys = obs_keys(rcfg, grad_norms=grad_norms, has_aux=has_aux, policy=policy)
    n = len(keys)
    return {"keys": keys, "n_keys": n, "device_bytes_per_step": 4 * n,
            "host_bytes_per_history_entry": 56 * n, "json_bytes_per_history_entry": 24 * n}
