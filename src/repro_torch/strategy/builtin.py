"""The paper's trio of strategies (§VI-D), and ``grasp_embed``: rehearsal
whose records carry the model's embedding, so the GRASP policy's prototype
distances run in embedding space (``buffer.policies.FEATURE_FIELD``)."""
from __future__ import annotations

import torch

from repro_torch.buffer.state import ItemSpec
from repro_torch.strategy.base import Strategy, make_tap_ce_loss, register_strategy


class IncrementalStrategy(Strategy):
    """Train on the new task only — the runtime lower bound; forgets."""

    name = "incremental"
    uses_buffer = False


class FromScratchStrategy(Strategy):
    """Retrain on all accumulated data with fresh params per task — the
    accuracy upper bound; quadratic runtime."""

    name = "from_scratch"
    uses_buffer = False
    fresh_params_per_task = True
    cumulative_data = True


class RehearsalStrategy(Strategy):
    """The paper's contribution: train each mini-batch augmented with
    representatives from the asynchronous distributed rehearsal buffer."""

    name = "rehearsal"
    uses_buffer = True


class GraspEmbedStrategy(Strategy):
    """Rehearsal with a model-embedding feature tap (GRASP at scale).

    Records gain an ``embed`` field, the penultimate activations of the model
    when the sample was seen; the GRASP policy's class prototypes and per-slot
    distances are computed on it instead of on raw inputs. The loss is the
    plain rehearsal CE."""

    name = "grasp_embed"
    uses_buffer = True
    needs_outputs = True
    recommended_policy = "grasp"

    def record_fields(self, item_spec, outputs_spec, scfg):
        if "embed" not in outputs_spec:
            raise ValueError(f"strategy {self.name!r} needs an 'embed' outputs tap; the "
                             f"model exposes {sorted(outputs_spec)}")
        return {"embed": ItemSpec(tuple(outputs_spec["embed"].shape), torch.float32)}

    def on_store(self, batch, outputs, scfg, mp=None):
        return dict(batch, embed=outputs["embed"].float())

    def build_loss(self, base_loss, forward_outputs, scfg, label_field: str = "labels",
                   mp=None):
        return make_tap_ce_loss(forward_outputs, label_field, mp)


register_strategy(IncrementalStrategy())
register_strategy(FromScratchStrategy())
register_strategy(RehearsalStrategy())
register_strategy(GraspEmbedStrategy())
