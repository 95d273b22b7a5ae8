"""Dark Experience Replay (DER / DER++) as registered strategies.

Buffer records gain stored-logit fields, the model's outputs when the sample
was seen, and the loss adds an MSE distillation term on the replayed
representatives (Buzzega et al., NeurIPS'20):

  DER   : loss = CE(new)                  + alpha * MSE(logits(reps), stored)
  DER++ : loss = CE(new) + beta * CE(reps) + alpha * MSE(logits(reps), stored)

The stored logits are ordinary record leaves: they ride the exchange, and
the tiered store's cold tier int8-quantizes the float ones like any float
leaf.

Top-k compression (``StrategyConfig.top_k``) stores only the k largest
(value, index) pairs per record. The pairs are stored in ascending index
order, so ``top_k == num_classes`` gives the dense distillation term bit
for bit.

On a model axis whose head is vocab-sharded (``mp``, the problem's
``vocab_mp``) the logits are each rank's shard of the vocabulary. The
records hold what the reference stores, over the whole vocabulary: the
dense row gathered from the shards, or the top-k merged from each shard's
own with global indices (``parallel.tensor.vocab_topk``). The loss never
gathers a [T, V] tensor: the CE terms are vocab-parallel, and the
distillation term is computed on the rank's shard of the stored logits (or
on the stored indices that fall in it) and summed over the model row.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.buffer.state import ItemSpec
from repro_torch.parallel.tensor import gather_vocab, reduce_from_model, vocab_pick, vocab_topk
from repro_torch.strategy.base import Strategy, mask_rows, register_strategy


def attach_logits(batch, logits, top_k: int = 0, sort_by_index: bool = False, mp=None):
    """The record batch with the logits to store: dense as ``logits``, or the
    top-k (value, index) pairs as ``logit_vals``/``logit_idx`` (i32), in
    value order (equal values by index), or in ascending index order with
    ``sort_by_index``. With ``mp``, ``logits`` is the rank's vocab shard
    and the record the whole vocabulary's."""
    if top_k:
        vals, idx = vocab_topk(logits, top_k, mp)
        if sort_by_index:
            idx, order = torch.sort(idx, dim=-1)
            vals = vals.gather(-1, order)
        return dict(batch, logit_vals=vals, logit_idx=idx.int())
    return dict(batch, logits=logits if mp is None else gather_vocab(logits, mp))


def distill_mse(logits, batch, top_k: int, mp=None):
    """Per-row MSE between this step's logits and the stored ones ([B]).
    With ``mp`` (``logits`` the rank's vocab shard), each rank sums the
    squares of its part (its slice of the stored row, or the stored indices
    in its shard) and *g* sums the parts over the model row: the mean of
    the whole row on every rank, each shard's gradient its own part's.
    Without, the one part is the whole row."""
    if top_k:
        got, inside = vocab_pick(logits.float(), batch["logit_idx"], mp)
        sq = torch.where(inside, torch.square(got - batch["logit_vals"]),
                         torch.zeros_like(got))
        count = got[0].numel()
    else:
        stored = batch["logits"]
        if mp is not None:
            stored = stored.narrow(-1, mp.index * logits.shape[-1], logits.shape[-1])
        sq = torch.square(logits.float() - stored)
        count = stored[0].numel() * (1 if mp is None else mp.size)
    part = sq.sum(dim=tuple(range(1, sq.dim())))
    return (part if mp is None else reduce_from_model(part, mp)) / count


def make_der_loss(forward_outputs: Callable, *, alpha: float = 0.5, beta: float = 0.0,
                  top_k: int = 0, label_field: str = "labels", mp=None):
    """The DER(++) loss over an augmented batch of b new and r replayed
    rows. Replayed rows carry stored logits; new rows carry zero
    placeholders, masked out by ``is_replay`` (1.0 on valid replay rows).
    One forward feeds the CE terms, the distillation term and (through the
    returned outputs) the logits stored for this batch. Every term is a
    mean over its valid rows or tokens, counted over the mesh step's group
    inside ``parallel.global_mean``. ``mp``: the model row the logits are
    vocab-sharded over (None: whole)."""
    from repro_torch.models.model_zoo import DEFAULT_AUX_WEIGHT, cross_entropy
    from repro_torch.parallel import global_count

    def loss_fn(model, batch):
        outputs = forward_outputs(model, batch)
        logits = outputs["logits"]
        labels = batch[label_field]
        is_replay = batch["is_replay"].float()
        ce_new = cross_entropy(logits, mask_rows(labels, 1.0 - is_replay), mp)
        mse = distill_mse(logits, batch, top_k, mp)
        distill = torch.sum(mse * is_replay) / torch.clamp(global_count(is_replay.sum()),
                                                           min=1.0)
        total = ce_new + alpha * distill
        metrics = {"ce": ce_new, "distill": distill}
        if beta:
            ce_replay = cross_entropy(logits, mask_rows(labels, is_replay), mp)
            total = total + beta * ce_replay
            metrics["ce_replay"] = ce_replay
        if "aux" in outputs:
            total = total + DEFAULT_AUX_WEIGHT * outputs["aux"]
        return total, (metrics, outputs)

    return loss_fn


def der_loss(model_loss: Callable, forward: Callable, *, alpha: float = 0.5,
             beta: float = 0.5, top_k: int = 0):
    """The reference's legacy standalone DER(++) loss on token logits
    ``[B, S, V]``: ``beta > 0`` keeps the full CE (replay rows included),
    ``beta == 0`` trains on distillation alone. The registered strategies
    use ``make_der_loss``."""

    def loss_fn(model, batch):
        ce, metrics = model_loss(model, batch)
        logits = forward(model, batch)
        is_replay = batch["is_replay"].float()
        denom = torch.clamp(is_replay.sum(), min=1.0)
        if top_k:
            got = logits.gather(-1, batch["logit_idx"].long())
            mse = torch.square(got - batch["logit_vals"]).mean(dim=(-2, -1))
        else:
            mse = torch.square(logits - batch["logits"].to(logits.dtype)).mean(dim=(-2, -1))
        distill = torch.sum(mse * is_replay) / denom
        total = ce + alpha * distill if beta else alpha * distill
        return total, dict(metrics, distill=distill)

    return loss_fn


def _top_k(scfg) -> int:
    return getattr(scfg, "top_k", 0) if scfg is not None else 0


class DerStrategy(Strategy):
    """DER: rehearsal where replayed rows are trained by logit distillation
    (MSE to the stored logits) instead of their labels."""

    name = "der"
    uses_buffer = True
    needs_outputs = True
    beta_from_config = False  # pure DER: no CE on replay rows

    def record_fields(self, item_spec, outputs_spec, scfg):
        if "logits" not in outputs_spec:
            raise ValueError(f"strategy {self.name!r} needs a 'logits' outputs tap; the "
                             f"model exposes {sorted(outputs_spec)}")
        row = outputs_spec["logits"]
        k = _top_k(scfg)
        if k:
            vocab = row.shape[-1]
            if k > vocab:
                raise ValueError(f"top_k={k} exceeds the logit dimension {vocab}")
            shape = tuple(row.shape[:-1]) + (k,)
            return {"logit_vals": ItemSpec(shape, torch.float32),
                    "logit_idx": ItemSpec(shape, torch.int32)}
        return {"logits": ItemSpec(tuple(row.shape), torch.float32)}

    def on_store(self, batch, outputs, scfg, mp=None):
        return attach_logits(batch, outputs["logits"], top_k=_top_k(scfg),
                             sort_by_index=True, mp=mp)

    def build_loss(self, base_loss, forward_outputs, scfg, label_field: str = "labels",
                   mp=None):
        alpha = getattr(scfg, "alpha", 0.5) if scfg is not None else 0.5
        beta = ((getattr(scfg, "beta", 0.5) if scfg is not None else 0.5)
                if self.beta_from_config else 0.0)
        return make_der_loss(forward_outputs, alpha=alpha, beta=beta, top_k=_top_k(scfg),
                             label_field=label_field, mp=mp)


class DerPPStrategy(DerStrategy):
    """DER++: DER plus a beta-weighted CE on the replayed rows' labels."""

    name = "der_pp"
    beta_from_config = True


register_strategy(DerStrategy())
register_strategy(DerPPStrategy())
