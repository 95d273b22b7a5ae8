"""Training strategies: the protocol, the registry and the shared loss helpers.

The paper evaluates three strategies (§VI-D): incremental, from_scratch and
rehearsal. Dark Experience Replay (der, der_pp) and grasp_embed extend the
buffer's records with fields computed from the model's outputs. A
``Strategy`` owns three hooks:

  * ``record_fields(item_spec, outputs_spec, scfg)``: the extra record field
    specs joined into the buffer's ``item_spec`` (``{}`` for the trio, whose
    step is unchanged);
  * ``on_store(batch, outputs, scfg, mp=None)``: the extra fields' values
    for the incoming mini-batch, from the outputs of the same step's
    forward;
  * ``build_loss(base_loss, forward_outputs, scfg, label_field, mp=None)``:
    the loss the step trains on. Tap strategies return ``(model, batch) ->
    (loss, (metrics, outputs))`` so that one forward feeds the loss and
    ``on_store``.

``mp`` is the model row a vocab-sharded head's logits are split over (the
problem's ``vocab_mp``; None without one): the records and the loss are
then those of the whole vocabulary, computed from the rank's shard.

Class attributes describe the trainer-facing shape of a strategy:
``uses_buffer`` (does the rehearsal machinery run), ``needs_outputs`` (does
the step need the model-outputs tap), ``fresh_params_per_task`` /
``cumulative_data`` (from_scratch's re-init and data), and
``recommended_policy`` (the buffer policy the trainer pairs it with when
the config leaves the policy at its default).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.buffer.state import ItemSpec


class Strategy:
    """Base strategy: plain task-stream training (the ``incremental`` lower
    bound). Stateless; subclasses override the hooks they need."""

    name: str = "incremental"
    uses_buffer: bool = False
    needs_outputs: bool = False
    fresh_params_per_task: bool = False
    cumulative_data: bool = False
    recommended_policy: Optional[str] = None

    def record_fields(self, item_spec, outputs_spec, scfg) -> Dict[str, ItemSpec]:
        """Extra field specs (name -> per-record ``ItemSpec``) joined into the
        buffer's ``item_spec``. ``outputs_spec`` holds the per-record specs
        of the model-outputs tap (no batch dim)."""
        return {}

    def on_store(self, batch, outputs, scfg, mp=None):
        """The [b, ...] record batch with the extra fields' values attached;
        ``outputs`` holds the tap's values for exactly these b rows."""
        return batch

    def build_loss(self, base_loss, forward_outputs, scfg, label_field: str = "labels",
                   mp=None):
        """The loss the step differentiates (``base_loss`` for the trio)."""
        return base_loss

    def placeholder_fields(self, aux_spec, batch_rows: int, device=None) -> Dict[str, Any]:
        """Zero-valued extra fields for the incoming batch: the augmented
        batch concatenates batch and representatives field by field, so both
        carry them; the loss masks the new rows' placeholders out through
        the ``is_replay`` flag."""
        return {name: torch.zeros((batch_rows,) + tuple(spec.shape), dtype=spec.dtype,
                                  device=device)
                for name, spec in aux_spec.items()}

    def __repr__(self) -> str:
        return f"{type(self).__name__}(name={self.name!r})"


# ---------------------------------------------------------------------------
# Shared loss helpers
# ---------------------------------------------------------------------------


def mask_rows(labels, row_mask):
    """Mask whole rows out of a CE: labels -> -1 where ``row_mask`` is 0.
    ``row_mask`` is f32/bool [B]; labels [B] or [B, S, ...]."""
    m = row_mask.reshape((labels.shape[0],) + (1,) * (labels.dim() - 1))
    return torch.where(m > 0, labels, torch.full_like(labels, -1))


def ce_from_outputs(outputs, batch, label_field: str, mp=None):
    """Label cross-entropy from the outputs tap (vocab-parallel over ``mp``),
    plus the MoE aux term (weighted as the LM loss weights it) when the
    model emits one. Returns ``(total, ce)``."""
    from repro_torch.models.model_zoo import DEFAULT_AUX_WEIGHT, cross_entropy

    ce = cross_entropy(outputs["logits"], batch[label_field], mp)
    total = ce
    if "aux" in outputs:
        total = total + DEFAULT_AUX_WEIGHT * outputs["aux"]
    return total, ce


def make_tap_ce_loss(forward_outputs: Callable, label_field: str, mp=None):
    """The plain CE loss routed through the outputs tap: the rehearsal loss,
    exposing ``(metrics, outputs)`` for ``on_store``."""

    def loss_fn(model, batch):
        outputs = forward_outputs(model, batch)
        total, ce = ce_from_outputs(outputs, batch, label_field, mp)
        return total, ({"ce": ce}, outputs)

    return loss_fn


def outputs_row_spec(forward_outputs: Callable, model, item_spec, device=None,
                     vocab_mp=None):
    """Per-record ``ItemSpec``s of the outputs tap: one forward of a zero
    one-record batch (without gradients) on ``device``, the batch dim
    stripped from every batched leaf (a scalar, the MoE aux, keeps ``()``).
    With ``vocab_mp`` (the logits a rank's vocab shard) the ``logits`` row
    is the whole vocabulary's, as the records store it."""
    batch = {k: torch.zeros((1,) + tuple(s.shape), dtype=s.dtype, device=device)
             for k, s in item_spec.items()}
    with torch.no_grad():
        outs = forward_outputs(model, batch)
    spec = {k: ItemSpec(tuple(v.shape[1:]) if v.dim() else (), v.dtype)
            for k, v in outs.items()}
    if vocab_mp is not None and "logits" in spec:
        shape = spec["logits"].shape
        spec["logits"] = ItemSpec(shape[:-1] + (shape[-1] * vocab_mp.size,),
                                  spec["logits"].dtype)
    return spec


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

STRATEGIES: Dict[str, Strategy] = {}


def register_strategy(strategy: Strategy) -> Strategy:
    """Register a strategy instance under ``strategy.name`` (last wins)."""
    STRATEGIES[strategy.name] = strategy
    return strategy


def get_strategy(name: str) -> Strategy:
    try:
        return STRATEGIES[name]
    except KeyError:
        raise KeyError(
            f"unknown strategy {name!r}; registered: {sorted(STRATEGIES)}") from None


def resolve_strategy(strategy) -> Strategy:
    """str -> registry lookup; Strategy -> itself; None -> rehearsal."""
    if strategy is None:
        return get_strategy("rehearsal")
    if isinstance(strategy, str):
        return get_strategy(strategy)
    if isinstance(strategy, Strategy):
        return strategy
    raise TypeError(f"expected a strategy name or Strategy, got {strategy!r}")
