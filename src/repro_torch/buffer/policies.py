"""Rehearsal-buffer policies: selection, eviction, sampling, with a registry.

A policy implements three decision hooks plus optional private state:

  * ``select_candidates(state, labels, gen, c) -> bool[b]``: which incoming
    samples enter the buffer (the paper's c/b lottery by default);
  * ``evict(state, labels, pos, rank, gen) -> [b]``: the target slot of each
    accepted candidate; ``pos`` is its would-be fill position (``pos >= cap``:
    the bucket is full and a record is displaced);
  * ``sample(state, gen, n) -> (flat [n], valid bool[n])``: flattened
    ``bucket * cap + slot`` rows to replay;
  * ``init_aux`` / ``update_aux`` / ``reshard_aux``: the policy's private
    state in ``BufferState.aux`` (FIFO's write cursor, GRASP's prototypes and
    per-slot distances), on the buffer's device.

The four policies of the reference are here: ``reservoir`` (Algorithm 1, the
default), ``fifo``, ``class_balanced`` and ``grasp``. Every hook draws from
an explicit ``torch.Generator`` on the buffer's device and never reads a
value back to the host, so it runs inside the train step without
synchronising with the card.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.buffer.state import BufferState, buffer_dims

_BIG = 1e30

# Record field holding model embeddings (the grasp_embed strategy's feature
# tap). When present, GRASP's prototype distances run in embedding space
# instead of on the raw first float leaf.
FEATURE_FIELD = "embed"


def _leaves_in_key_order(tree):
    """The leaves of a dict tree with each dict's keys sorted: the order of
    the reference's ``jax.tree_util.tree_leaves``."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_in_key_order(tree[k])
    else:
        yield tree


def _feature_leaf(items):
    """The record leaf GRASP features come from: the ``embed`` field when the
    records carry one, else the first float leaf (in sorted key order), else
    the first leaf. ``items`` holds tensors or ``ItemSpec``s."""
    if isinstance(items, dict) and FEATURE_FIELD in items:
        return items[FEATURE_FIELD]
    leaves = list(_leaves_in_key_order(items))
    return next((leaf for leaf in leaves if leaf.dtype.is_floating_point), leaves[0])


def _features(items) -> torch.Tensor:
    """[b, D] f32 features of a record batch (the flattened feature leaf)."""
    leaf = _feature_leaf(items)
    return leaf.reshape(leaf.shape[0], -1).float()


def _feature_dim(item_spec) -> int:
    d = 1
    for s in _feature_leaf(item_spec).shape:
        d *= s
    return d


def _uniform_below(gen, n: int, bound: torch.Tensor) -> torch.Tensor:
    """n uniform integers in [0, max(bound, 1)) with no host read of
    ``bound`` (``torch.randint`` needs a Python bound)."""
    draw = torch.rand(n, generator=gen, device=bound.device, dtype=torch.float64)
    return torch.floor(draw * torch.clamp(bound, min=1)).long()


class Policy:
    """Base policy = the paper's per-bucket reservoir (Algorithm 1). Stateless."""

    name = "reservoir"

    # -- private state -----------------------------------------------------
    def init_aux(self, item_spec, num_buckets: int, slots: int, device=None):
        return ()

    def update_aux(self, state: BufferState, items, labels, accept, flat, new_counts):
        return state.aux

    def reshard_aux(self, data, counts):
        """Rebuild aux for ONE worker whose ``data``/``counts`` were compacted
        by an elastic reshard. Stateless policies return ()."""
        return ()

    # -- gauges (repro_torch.obs) ------------------------------------------
    def obs_parts(self, state: BufferState):
        """The additive parts (f32 scalars) of the policy's ``obs/*`` gauges:
        summed over ranks, ``obs_finish`` makes the global gauges of them.
        Pure reads: no draw, no state change. Stateless policies: none."""
        return {}

    def obs_finish(self, parts):
        return {}

    def obs_aux(self, state: BufferState):
        """The policy's ``obs/*`` gauges of one buffer (``buffer_api.buffer_obs``)."""
        return self.obs_finish(self.obs_parts(state))

    # -- decision hooks ----------------------------------------------------
    def select_candidates(self, state: BufferState, labels, gen, num_candidates: int):
        """Every incoming sample enters with probability c/b."""
        b = labels.shape[0]
        return torch.rand(b, generator=gen, device=labels.device) < (num_candidates / b)

    def evict(self, state: BufferState, labels, pos, rank, gen):
        """Fill position while the bucket has room, else a uniform slot."""
        _, cap = buffer_dims(state)
        evict = torch.randint(0, cap, (labels.shape[0],), generator=gen,
                              device=labels.device)
        return torch.where(pos < cap, torch.clamp(pos, max=cap - 1), evict)

    def sample(self, state: BufferState, gen, n: int):
        """Uniform over filled slots: draw u in [0, total) and find its bucket
        with ``searchsorted(cumsum(counts), u, right=True)``."""
        k_buckets, cap = buffer_dims(state)
        counts = state.counts.long()
        total = counts.sum()
        u = _uniform_below(gen, n, total)
        cum = torch.cumsum(counts, 0)
        bucket = torch.clamp(torch.searchsorted(cum, u, right=True), max=k_buckets - 1)
        within = u - (cum[bucket] - counts[bucket])
        flat = bucket * cap + torch.clamp(within, 0, cap - 1)
        valid = (total > 0).repeat(n)
        return flat, valid


class FifoPolicy(Policy):
    """FIFO ring per bucket: a full bucket overwrites its oldest record.
    ``aux['cursor']`` is the per-bucket write head; while a bucket fills,
    cursor == counts, so the fill order is the reservoir's."""

    name = "fifo"

    def init_aux(self, item_spec, num_buckets: int, slots: int, device=None):
        return {"cursor": torch.zeros((num_buckets,), dtype=torch.int32, device=device)}

    def evict(self, state: BufferState, labels, pos, rank, gen):
        _, cap = buffer_dims(state)
        return (state.aux["cursor"].long()[labels] + rank) % cap

    def update_aux(self, state: BufferState, items, labels, accept, flat, new_counts):
        k_buckets, cap = buffer_dims(state)
        onehot = F.one_hot(labels.long(), k_buckets) * accept[:, None].long()
        cursor = (state.aux["cursor"].long() + onehot.sum(0)) % cap
        return {"cursor": cursor.int()}

    def reshard_aux(self, data, counts):
        # resharding compacts records into slots [0, counts): resume the ring
        # at the first empty slot (ages were re-dealt, so slot 0 is the oldest)
        cap = next(_leaves_in_key_order(data)).shape[1]
        return {"cursor": (torch.as_tensor(counts).int() % cap).int()}


class ClassBalancedPolicy(Policy):
    """Class-balanced acceptance and replay (Buzzega et al., 2020): under-filled
    buckets accept more often, and sampling draws a non-empty bucket
    uniformly, then a slot within it."""

    name = "class_balanced"

    def select_candidates(self, state: BufferState, labels, gen, num_candidates: int):
        b = labels.shape[0]
        counts = state.counts.float()
        boost = (1.0 + counts.mean()) / (1.0 + counts[labels.long()])
        p = torch.clamp((num_candidates / b) * boost, 0.0, 1.0)
        return torch.rand(b, generator=gen, device=labels.device) < p

    def sample(self, state: BufferState, gen, n: int):
        k_buckets, cap = buffer_dims(state)
        counts = state.counts.long()
        nonzero = (counts > 0).long()
        r = _uniform_below(gen, n, nonzero.sum())
        bucket = torch.clamp(torch.searchsorted(torch.cumsum(nonzero, 0), r, right=True),
                             max=k_buckets - 1)
        u = torch.rand(n, generator=gen, device=counts.device)
        within = (u * counts[bucket].float()).long()  # truncation, as astype(int32)
        flat = bucket * cap + torch.clamp(within, 0, cap - 1)
        valid = (counts.sum() > 0).repeat(n)
        return flat, valid


def _last_wins(flat: torch.Tensor, rows: int) -> torch.Tensor:
    """``flat`` with every entry that a later entry targets again, and every
    entry ``>= rows``, redirected to the spare row ``rows``: a scatter into
    ``rows + 1`` slots then keeps the last duplicate and drops the rest."""
    b = flat.shape[0]
    later = torch.triu(torch.ones((b, b), dtype=torch.bool, device=flat.device), 1)
    superseded = ((flat[:, None] == flat[None, :]) & later).any(1)
    return torch.where(superseded | (flat >= rows) | (flat < 0),
                       torch.full_like(flat, rows), flat)


class GraspPolicy(Policy):
    """GRASP-style prototype-distance ordering (Harun et al., 2023).

    Keeps a running class prototype (mean feature) per bucket and each stored
    record's distance to it. A full bucket evicts its least prototypical
    records (largest distance) first, and sampling is Gumbel-top-k over
    ``-beta * distance``: without replacement, the prototypical records
    replayed most often."""

    name = "grasp"
    beta = 1.0  # inverse temperature of the distance-ordered sampling

    def init_aux(self, item_spec, num_buckets: int, slots: int, device=None):
        d = _feature_dim(item_spec)
        return {
            "proto": torch.zeros((num_buckets, d), dtype=torch.float32, device=device),
            "proto_n": torch.zeros((num_buckets,), dtype=torch.float32, device=device),
            "dist": torch.full((num_buckets, slots), _BIG, dtype=torch.float32,
                               device=device),
        }

    def evict(self, state: BufferState, labels, pos, rank, gen):
        _, cap = buffer_dims(state)
        # the j-th overflow candidate of a bucket displaces the j-th least
        # prototypical slot, so same-batch evictions hit distinct slots; the
        # reference's argsort is stable, hence stable=True
        order = torch.argsort(-state.aux["dist"], dim=1, stable=True)
        j = torch.clamp(pos - cap, 0, cap - 1)
        return torch.where(pos < cap, torch.clamp(pos, max=cap - 1),
                           order[labels.long(), j])

    def update_aux(self, state: BufferState, items, labels, accept, flat, new_counts):
        if items is None:
            raise ValueError("the grasp policy's update needs the incoming records "
                             "(items=) for its prototype features")
        k_buckets, cap = buffer_dims(state)
        aux = state.aux
        labels = labels.long()
        feats = _features(items)  # [b, D]
        onehot = F.one_hot(labels, k_buckets).float() * accept[:, None].float()
        # per-bucket sums as a product and a reduction in f32 (a matmul would
        # run in TF32 where the caller allows it)
        sums = (onehot.t()[:, :, None] * feats[None]).sum(1)  # [K, D]
        proto_n = aux["proto_n"] + onehot.sum(0)
        proto = (aux["proto"] * aux["proto_n"][:, None] + sums) / torch.clamp(
            proto_n, min=1.0)[:, None]
        d = torch.linalg.vector_norm(feats - proto[labels], dim=1)
        # the reference's scatter drops rows out of range and keeps the last
        # duplicate
        target = _last_wins(flat.long(), k_buckets * cap)
        dist = torch.cat([aux["dist"].reshape(-1), aux["dist"].new_zeros(1)])
        dist = dist.index_put((target,), d)[:-1]
        return {"proto": proto, "proto_n": proto_n, "dist": dist.view(k_buckets, cap)}

    def reshard_aux(self, data, counts):
        # the stored features are the records: recompute prototypes and
        # per-slot distances from the re-dealt records
        leaf = _feature_leaf(data)
        k_buckets, cap = leaf.shape[0], leaf.shape[1]
        feats = leaf.reshape(k_buckets, cap, -1).float()
        counts = torch.as_tensor(counts, device=leaf.device).int()
        filled = torch.arange(cap, device=leaf.device)[None, :] < counts[:, None]
        proto_n = counts.float()
        proto = (feats * filled[:, :, None]).sum(1) / torch.clamp(proto_n, min=1.0)[:, None]
        dist = torch.linalg.vector_norm(feats - proto[:, None, :], dim=-1)
        return {"proto": proto, "proto_n": proto_n,
                "dist": torch.where(filled, dist, torch.full_like(dist, _BIG))}

    def obs_parts(self, state: BufferState):
        # the mean prototype distance over filled slots, the selection
        # pressure GRASP makes visible, as its sum and its count
        dist = state.aux["dist"]
        filled = torch.arange(dist.shape[-1], device=dist.device) < state.counts[..., None]
        return {"grasp_dist_sum": torch.where(filled, dist, torch.zeros_like(dist)).sum(),
                "grasp_filled": filled.float().sum()}

    def obs_finish(self, parts):
        return {"obs/grasp_mean_dist":
                parts["grasp_dist_sum"] / torch.clamp(parts["grasp_filled"], min=1.0)}

    def sample(self, state: BufferState, gen, n: int):
        k_buckets, cap = buffer_dims(state)
        dist = state.aux["dist"]
        filled = (torch.arange(cap, device=dist.device)[None, :]
                  < state.counts[:, None]).reshape(-1)
        u = torch.rand(k_buckets * cap, generator=gen, device=dist.device)
        gumbel = -torch.log(-torch.log(torch.clamp(u, min=torch.finfo(u.dtype).tiny)))
        score = -self.beta * dist.reshape(-1) + gumbel
        score = torch.where(filled, score, torch.full_like(score, -_BIG))
        # ties are the -1e30 unfilled slots only, and their draws are
        # marked invalid, so topk's tie order (not the reference's) is harmless
        flat = torch.topk(score, min(n, k_buckets * cap)).indices
        if n > k_buckets * cap:  # ceil-tile when asked beyond capacity
            flat = flat.repeat(-(-n // (k_buckets * cap)))[:n]
        # top-k draws without replacement: when fill < n the surplus lands on
        # unfilled slots, marked invalid (label-masked by the consumer)
        return flat, filled[flat]


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

POLICIES: Dict[str, Policy] = {}


def register_policy(policy: Policy) -> Policy:
    """Register a policy instance under ``policy.name`` (last registration wins)."""
    POLICIES[policy.name] = policy
    return policy


DEFAULT_POLICY = register_policy(Policy())
register_policy(FifoPolicy())
register_policy(ClassBalancedPolicy())
register_policy(GraspPolicy())


def get_policy(name: str) -> Policy:
    try:
        return POLICIES[name]
    except KeyError:
        raise KeyError(
            f"unknown buffer policy {name!r}; registered: {sorted(POLICIES)}") from None


def resolve_policy(policy) -> Policy:
    """None -> the default reservoir; str -> registry lookup; Policy -> itself."""
    if policy is None:
        return DEFAULT_POLICY
    if isinstance(policy, str):
        return get_policy(policy)
    return policy
