"""Roofline of a step on one NVIDIA H100 SXM (80 GB HBM3), per rank.

The reference's model (``repro/analysis/roofline.py``) with the card's
peaks in place of the TPU's:

    compute    = flops / peak(compute dtype)
    memory     = bytes accessed / HBM_BW
    collective = sum over collective calls of wire_bytes(call) / LINK_BW

  * ``PEAK_FLOPS``: dense bf16 on the tensor cores, 989e12 FLOP/s;
    ``PEAK_FLOPS_TF32`` 495e12 and ``PEAK_FLOPS_F32`` (FMA on the CUDA
    cores) 67e12. The compute dtype picks the peak (``peak_flops``).
  * ``HBM_BW``: 3.35e12 B/s.
  * ``LINK_BW``: NVLink 4, 450e9 B/s each way, for the collective term.

All five are the H100 SXM datasheet's figures, the peaks that the kernel
bounds of ``chip_smoke.py`` use; none was measured here. (The host link
that the tiered store's cold tier crosses was measured at about 55 GB/s on
the card machine, ``PERF.md``; it does not enter this model.)

Torch has no compiled program to read, so ``collective_bytes`` takes the
collective calls a step made (``Collective``: kind, per-rank result bytes,
group size), recorded by the dry run, and applies the reference's ring
estimates:

  all-reduce 2·S·(g-1)/g | all-gather S·(g-1)/g | reduce-scatter S·(g-1)
  all-to-all S·(g-1)/g   | send/recv S

(S the per-rank result bytes: the gathered size for all-gather, the
scattered size for reduce-scatter.)

MODEL_FLOPS = 6·N_active·tokens (train) or 2·N_active·tokens (inference);
the ratio MODEL_FLOPS / (flops·chips) exposes recompute and waste.
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from typing import Dict, Iterable, NamedTuple, Optional, Tuple

PEAK_FLOPS = 989e12  # bf16 dense, tensor cores
PEAK_FLOPS_TF32 = 495e12
PEAK_FLOPS_F32 = 67e12  # FMA on the CUDA cores
HBM_BW = 3.35e12  # bytes/s
LINK_BW = 450e9  # bytes/s each way, NVLink 4

_PEAKS = {"bfloat16": PEAK_FLOPS, "float16": PEAK_FLOPS, "tf32": PEAK_FLOPS_TF32,
          "float32": PEAK_FLOPS_F32}

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "send/recv")


def peak_flops(compute_dtype: str = "bfloat16") -> float:
    """The card's peak FLOP/s for a step computing in ``compute_dtype``
    (``bfloat16``, ``float16``, ``tf32`` or ``float32``)."""
    if compute_dtype not in _PEAKS:
        raise ValueError(f"no peak for {compute_dtype!r}; expected one of {sorted(_PEAKS)}")
    return _PEAKS[compute_dtype]


class Collective(NamedTuple):
    """One collective call of a rank: ``kind`` (one of ``KINDS``), the
    per-rank result ``bytes`` and the ``group`` size."""

    kind: str
    bytes: int
    group: int


def wire_bytes(call: Collective) -> float:
    """The ring estimate of the bytes ``call`` puts on a rank's links."""
    s, g = float(call.bytes), max(int(call.group), 1)
    if call.kind == "all-reduce":
        return 2 * s * (g - 1) / g
    if call.kind in ("all-gather", "all-to-all"):
        return s * (g - 1) / g
    if call.kind == "reduce-scatter":
        return s * (g - 1)
    if call.kind == "send/recv":
        return s
    raise ValueError(f"unknown collective kind {call.kind!r}; expected one of {KINDS}")


def collective_bytes(calls: Iterable[Collective]) -> Dict[str, Dict[str, float]]:
    """Per collective kind: the summed per-rank wire bytes and the call
    count (the reference's ``parse_collectives`` over recorded calls)."""
    out: Dict[str, Dict[str, float]] = {}
    for call in calls:
        d = out.setdefault(call.kind, {"bytes": 0.0, "count": 0})
        d["bytes"] += wire_bytes(call)
        d["count"] += 1
    return out


# ---------------------------------------------------------------------------
# Ideal-time estimators (the "roofline" the fractions are measured against)
# ---------------------------------------------------------------------------


def _attn_layers(cfg) -> int:
    return sum(1 for i in range(cfg.num_layers) if cfg.layer_kind(i) == "attn") + (
        2 * cfg.num_encoder_layers  # whisper: enc self-attn + dec cross-attn
    )


def _ssm_layers(cfg) -> int:
    return sum(1 for i in range(cfg.num_layers) if cfg.layer_kind(i) == "ssm")


def estimate_model_flops(cfg, kind: str, tokens: int, ctx_len: int) -> float:
    """Useful-math FLOPs: 6·N_active·D (train) / 2·N_active·D (inference) for
    the linear layers, plus the attention score/value products (causal
    halves the average context; a sliding window caps it) and the SSD state
    math."""
    mult = 6 if kind == "train" else 2
    total = float(mult * cfg.active_param_count() * tokens)
    if cfg.num_heads:
        if kind == "decode":
            ctx = min(ctx_len, cfg.sliding_window) if cfg.sliding_window else ctx_len
        else:
            eff = min(ctx_len, cfg.sliding_window) if cfg.sliding_window else ctx_len
            ctx = eff / 2  # causal average
        attn_fwd = 4.0 * cfg.num_heads * cfg.head_dim * tokens * ctx
        total += attn_fwd * (3 if kind == "train" else 1) * _attn_layers(cfg)
    if cfg.ssm_state:
        d_in = cfg.ssm_expand * cfg.d_model
        # state inject + output read (~2·d_in·N each) + intra-chunk quadratic term
        per_tok = 4.0 * d_in * cfg.ssm_state + 2.0 * d_in * (cfg.ssm_chunk / 2)
        total += per_tok * tokens * (3 if kind == "train" else 1) * _ssm_layers(cfg)
    return total


def estimate_min_bytes_per_chip(cfg, kind: str, tokens: int, ctx_len: int,
                                chips: int, model_size: int,
                                cache_bytes_total: float = 0.0) -> float:
    """HBM-traffic floor per rank per step (perfect fusion):

      train:   20 B/param local (bf16 fwd+bwd reads, f32 grad + opt state r/w)
               + ~8 activation tensors/layer streamed once each way
      prefill: 2 B/param + 4 tensors/layer
      decode:  2 B/param (whole model read per step) + the KV/SSM cache read+write
    """
    params_local = cfg.param_count() / max(model_size, 1)
    tok_local = tokens / chips
    act_width = cfg.d_model * 2  # bf16
    layers = cfg.num_layers + cfg.num_encoder_layers
    if kind == "train":
        return 20.0 * params_local + 8 * layers * tok_local * act_width
    if kind == "prefill":
        return 2.0 * params_local + 4 * layers * tok_local * act_width
    return 2.0 * params_local + 1.5 * cache_bytes_total / chips


def cache_bytes_total(cfg, batch: int, seq_len: int) -> float:
    """Decode-cache footprint (bf16 KV rings / f32 SSM states), whole model."""
    total = 0.0
    for i in range(cfg.num_layers):
        if cfg.layer_kind(i) == "attn":
            size = min(cfg.sliding_window, seq_len) if cfg.sliding_window else seq_len
            total += 2 * batch * size * cfg.num_kv_heads * cfg.head_dim * 2
        else:
            d_in = cfg.ssm_expand * cfg.d_model
            h = d_in // cfg.ssm_head_dim
            total += batch * h * cfg.ssm_state * cfg.ssm_head_dim * 4
    for _ in range(cfg.num_encoder_layers):  # whisper decoder: self + cross caches
        total += 4 * batch * seq_len * cfg.num_kv_heads * cfg.head_dim * 2
    return total


def ideal_seconds(cfg, kind: str, tokens: int, ctx_len: int, chips: int,
                  model_size: int, batch: int = 0,
                  compute_dtype: str = "bfloat16") -> Tuple[float, float]:
    """(ideal_compute_s, ideal_memory_s) per rank."""
    cb = cache_bytes_total(cfg, batch, ctx_len) if kind == "decode" else 0.0
    fl = estimate_model_flops(cfg, kind, tokens, ctx_len) / chips
    by = estimate_min_bytes_per_chip(cfg, kind, tokens, ctx_len, chips, model_size, cb)
    return fl / peak_flops(compute_dtype), by / HBM_BW


@dataclass
class RooflineResult:
    arch: str
    shape: str
    mesh: str
    kind: str  # train | prefill | decode
    chips: int
    flops_per_chip: float
    bytes_per_chip: float
    collective_bytes_per_chip: float
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: float  # useful-math FLOPs, global
    useful_ratio: float  # model_flops / (flops_per_chip * chips)
    roofline_fraction: float  # model-flops-time / dominant-term time
    per_collective: Dict[str, Dict[str, float]] = field(default_factory=dict)
    memory_per_device_bytes: Optional[float] = None
    peak_flops: float = PEAK_FLOPS
    notes: str = ""

    def to_json(self) -> str:
        return json.dumps(asdict(self), indent=1)


def terms(flops: float, bytes_accessed: float, coll_bytes: float,
          peak: float) -> Dict[str, float]:
    """The three per-rank times of the model."""
    return {"compute": flops / peak, "memory": bytes_accessed / HBM_BW,
            "collective": coll_bytes / LINK_BW}


def analyze(
    *,
    arch: str,
    shape: str,
    mesh_name: str,
    kind: str,
    chips: int,
    cost: Dict[str, float],
    collectives: Iterable[Collective],
    active_params: int,
    tokens_per_step: int,
    memory_bytes: Optional[float] = None,
    compute_dtype: str = "bfloat16",
    notes: str = "",
) -> RooflineResult:
    """The roofline of one rank's step from its counted ``cost`` (``flops``
    and ``bytes accessed``) and recorded ``collectives``."""
    flops = float(cost.get("flops", 0.0))
    bytes_accessed = float(cost.get("bytes accessed", 0.0))
    coll = collective_bytes(collectives)
    coll_bytes = sum(d["bytes"] for d in coll.values())
    peak = peak_flops(compute_dtype)
    t = terms(flops, bytes_accessed, coll_bytes, peak)
    bottleneck = max(t, key=t.get)

    mult = 6 if kind == "train" else 2
    model_flops = mult * active_params * tokens_per_step
    useful = model_flops / max(flops * chips, 1.0)
    # fraction of the dominant-term roofline that useful math occupies
    ideal_s = (model_flops / chips) / peak
    roofline_fraction = ideal_s / max(max(t.values()), 1e-12)
    return RooflineResult(
        arch=arch, shape=shape, mesh=mesh_name, kind=kind, chips=chips,
        flops_per_chip=flops, bytes_per_chip=bytes_accessed,
        collective_bytes_per_chip=coll_bytes,
        compute_s=t["compute"], memory_s=t["memory"], collective_s=t["collective"],
        bottleneck=bottleneck, model_flops=model_flops, useful_ratio=useful,
        roofline_fraction=roofline_fraction, per_collective=coll,
        memory_per_device_bytes=memory_bytes, peak_flops=peak, notes=notes,
    )
