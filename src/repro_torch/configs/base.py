"""Model and run configuration: LM architecture, rehearsal, scenario,
training and the run itself.

The port's own copy of the fields of ``repro.configs.base`` that the ported
slices read: the rehearsal trainer and its scenarios, the language-model
path (``ModelConfig``, ``reduce_model``), online serving
(``OnlineConfig``) and the fault-tolerant loop (``ResilienceConfig``). Field names, defaults and validation match the
reference, so a config written for one package reads the same in the other.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional, Tuple


# ---------------------------------------------------------------------------
# Model architecture
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description covering dense / MoE / SSM / hybrid / enc-dec /
    VLM LMs. The port runs the dense and SSM decoders; the other families'
    fields are kept so configs read the same in both packages."""

    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    activation: str = "swiglu"  # swiglu | geglu | gelu
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    rope_theta: float = 10000.0
    use_rope: bool = True
    m_rope: bool = False  # qwen2-vl 3D multimodal rope
    m_rope_sections: Tuple[int, ...] = (16, 24, 24)  # (t, h, w) split of head_dim/2
    sliding_window: int = 0  # 0 = full attention
    # --- MoE ---
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_layer_period: int = 1  # MoE every k-th layer (jamba: 2), dense FFN otherwise
    capacity_factor: float = 1.25
    expert_sharding: str = "auto"  # auto | ep | tp
    # --- SSM (Mamba-2 / SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_dim: int = 4
    ssm_chunk: int = 128
    # --- hybrid (jamba) ---
    attn_layer_period: int = 0  # attention every k-th layer; 0 = per-family default
    attn_layer_offset: int = 4
    # --- enc-dec (whisper) ---
    num_encoder_layers: int = 0
    # --- modality frontend stubs ---
    frontend: str = "none"  # none | patch_stub (vlm) | frame_stub (audio)
    tie_embeddings: bool = False
    logit_softcap: float = 0.0
    source: str = ""  # provenance note ([arXiv/hf ref; tier])

    def __post_init__(self):
        if self.num_heads and not self.head_dim:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        """SWA-bounded or (partially) attention-free."""
        return self.sliding_window > 0 or self.family in ("ssm", "hybrid")

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    def layer_kind(self, i: int) -> str:
        """Mixer kind for layer i: 'attn' or 'ssm' (hybrid interleave support)."""
        if self.family == "ssm":
            return "ssm"
        if self.family == "hybrid":
            period = self.attn_layer_period or 8
            return "attn" if (i % period) == self.attn_layer_offset else "ssm"
        return "attn"

    def layer_is_moe(self, i: int) -> bool:
        return self.is_moe and (i % self.moe_layer_period) == (self.moe_layer_period - 1)

    def param_count(self) -> int:
        """Analytic parameter count (embedding + per-layer blocks), total (all experts)."""
        return _param_count(self, active_only=False)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top-k experts only)."""
        return _param_count(self, active_only=True)


def _ffn_params(cfg: ModelConfig, d_ff: int) -> int:
    mats = 3 if cfg.activation in ("swiglu", "geglu") else 2
    return mats * cfg.d_model * d_ff


def _attn_params(cfg: ModelConfig) -> int:
    q = cfg.d_model * cfg.num_heads * cfg.head_dim
    kv = 2 * cfg.d_model * cfg.num_kv_heads * cfg.head_dim
    o = cfg.num_heads * cfg.head_dim * cfg.d_model
    return q + kv + o


def _ssm_params(cfg: ModelConfig) -> int:
    d_in = cfg.ssm_expand * cfg.d_model
    nheads = d_in // cfg.ssm_head_dim
    # in_proj: z, x, B, C, dt ; out_proj ; conv ; A, D, dt_bias, norm
    in_proj = cfg.d_model * (2 * d_in + 2 * cfg.ssm_state + nheads)
    out_proj = d_in * cfg.d_model
    conv = (d_in + 2 * cfg.ssm_state) * cfg.ssm_conv_dim
    extras = 3 * nheads + d_in
    return in_proj + out_proj + conv + extras


def _param_count(cfg: ModelConfig, active_only: bool) -> int:
    total = cfg.vocab_size * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    for i in range(cfg.num_layers):
        total += 2 * cfg.d_model  # norms
        if cfg.layer_kind(i) == "ssm":
            total += _ssm_params(cfg)
        else:
            total += _attn_params(cfg)
        if cfg.layer_is_moe(i):
            e = cfg.num_experts_per_tok if active_only else cfg.num_experts
            total += e * _ffn_params(cfg, cfg.d_ff) + cfg.d_model * cfg.num_experts
        elif cfg.d_ff:
            total += _ffn_params(cfg, cfg.d_ff)
    for _ in range(cfg.num_encoder_layers):
        total += 2 * cfg.d_model + _attn_params(cfg) + _ffn_params(cfg, cfg.d_ff)
        total += _attn_params(cfg)  # decoder cross-attention (paired with encoder layers)
    return total


def reduce_model(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Shrink a config for CPU smoke tests while preserving family structure."""
    small = dict(
        num_layers=min(cfg.num_layers, 4 if cfg.family != "hybrid" else 8),
        d_model=128,
        num_heads=4 if cfg.num_heads else 0,
        num_kv_heads=min(cfg.num_kv_heads, 2) if cfg.num_kv_heads else 0,
        head_dim=32 if cfg.num_heads else 0,
        d_ff=256 if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 512),
        num_experts=min(cfg.num_experts, 4) if cfg.num_experts else 0,
        num_experts_per_tok=min(cfg.num_experts_per_tok, 2) if cfg.num_experts else 0,
        sliding_window=min(cfg.sliding_window, 64) if cfg.sliding_window else 0,
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_head_dim=32 if cfg.ssm_state else 64,
        ssm_chunk=16 if cfg.ssm_state else 128,
        num_encoder_layers=min(cfg.num_encoder_layers, 2),
        name=cfg.name + "-reduced",
    )
    if cfg.num_kv_heads == 1:  # preserve MQA structure (gemma)
        small["num_kv_heads"] = 1
    small.update(overrides)
    return dataclasses.replace(cfg, **small)


@dataclass(frozen=True)
class RehearsalConfig:
    """The rehearsal buffer (notation of Table I of the paper)."""

    num_buckets: int = 4  # K: classes (vision) or tasks
    slots_per_bucket: int = 16  # |R_n^i|: local per-bucket capacity = S_max / K
    num_representatives: int = 7  # r: samples appended to each mini-batch
    num_candidates: int = 14  # c: expected candidates pushed per mini-batch
    mode: str = "async"  # async (pipelined) | sync (blocking baseline) | off
    # Train on step t-1's representatives while issuing step t+1's sample;
    # mode='async' implies it.
    pipelined: bool = False
    policy: str = "reservoir"  # reservoir | fifo | class_balanced | grasp
    # Tiered store: 'off' keeps the whole buffer on the device; 'host' adds an
    # int8-quantized cold tier in pinned host memory (plain host memory on the
    # CPU), so per-bucket capacity can exceed device memory.
    tiering: str = "off"  # off | host
    hot_slots: int = 0  # tiered: hot (device) slots/bucket; 0 -> slots_per_bucket
    cold_slots: int = 0  # tiered: cold (host, int8) slots/bucket; 0 -> 3x hot
    demote_stage: int = 0  # tiered: demotion staging rows; 0 -> 2x num_candidates
    # Tiered hot path through the fused kernels: cold sampling dequantizes on
    # the gather, demotion flushes quantize on the scatter. Bit-identical to
    # the default quantize -> scatter / gather -> dequantize chain.
    fused_kernels: bool = False
    label_field: str = "labels"
    task_field: str = "task"

    def __post_init__(self):
        if self.tiering == "on":  # convenience alias: 'on' means the host tier
            object.__setattr__(self, "tiering", "host")
        if self.tiering not in ("off", "host"):
            raise ValueError(
                f"unknown tiering {self.tiering!r}; expected 'off', 'host' "
                f"(or the alias 'on')")
        if self.mode not in ("async", "sync", "off"):
            raise ValueError(
                f"unknown rehearsal mode {self.mode!r}; expected async|sync|off")

    @property
    def enabled(self) -> bool:
        return self.mode != "off"

    @property
    def is_pipelined(self) -> bool:
        """One-step-stale double buffering on? (False: the blocking sync path.)"""
        return self.enabled and (self.pipelined or self.mode == "async")

    @property
    def tiered(self) -> bool:
        return self.enabled and self.tiering != "off"

    @property
    def resolved_hot_slots(self) -> int:
        return self.hot_slots or self.slots_per_bucket

    @property
    def resolved_cold_slots(self) -> int:
        return self.cold_slots or 3 * self.resolved_hot_slots

    @property
    def resolved_demote_stage(self) -> int:
        return self.demote_stage or 2 * self.num_candidates

    @property
    def total_slots_per_bucket(self) -> int:
        """Effective per-bucket capacity: hot + cold when tiered, else the flat size."""
        if self.tiered:
            return self.resolved_hot_slots + self.resolved_cold_slots
        return self.slots_per_bucket


@dataclass(frozen=True)
class ScenarioConfig:
    """The continual-learning scenario a run trains on, and its schedule."""

    name: str = "class_incremental"
    modality: str = "vision"
    # incremental | from_scratch | rehearsal | der | der_pp | grasp_embed
    strategy: str = "rehearsal"
    num_tasks: int = 4
    epochs_per_task: int = 1
    steps_per_epoch: int = 50
    batch_size: int = 16
    seed: int = 0
    classes_per_task: int = 10  # class_incremental / blurry_boundary (vision)
    num_classes: int = 10  # domain_incremental: shared label space size
    image_size: int = 32
    noise: float = 0.35
    vocab_size: int = 256  # tokens modality
    seq_len: int = 32  # tokens modality
    domain_shift: float = 1.0  # domain_incremental: per-domain transform strength
    blur: float = 0.25  # blurry_boundary: blurred fraction of each task's span
    # Let the scenario fill rehearsal fields still at their dataclass defaults.
    auto_defaults: bool = True

    @property
    def steps_per_task(self) -> int:
        return self.epochs_per_task * self.steps_per_epoch


@dataclass(frozen=True)
class TrainConfig:
    """The paper's SGD recipe (§VI-A), and AdamW for the language models."""

    optimizer: str = "sgd"  # sgd (paper) | adamw
    peak_lr: float = 0.0125
    warmup_steps: int = 100
    decay_milestones: Tuple[Tuple[int, float], ...] = ()  # (step, factor)
    weight_decay: float = 1e-5
    momentum: float = 0.9
    max_scaled_lr: float = 64.0  # LR cap under linear scaling
    linear_scaling: bool = True  # multiply LR by the number of DP workers
    grad_clip: float = 1.0
    compute_dtype: str = "bfloat16"  # the LM's activations: bfloat16 | float32
    grad_compress: str = "none"  # none | int8 (error-feedback quantized all-reduce)


@dataclass(frozen=True)
class StrategyConfig:
    """Hyper-parameters of the training strategy (``repro_torch.strategy``).

    The strategy name lives in ``ScenarioConfig.strategy`` (or the trainer's
    ``strategy=``); the built-in trio ignores these knobs, DER/DER++ read
    ``alpha``/``beta``/``top_k``."""

    alpha: float = 0.5  # DER: weight of the logit-MSE distillation term
    beta: float = 0.5  # DER++: weight of the replay-row CE term (der ignores it)
    # Store only the top-k (value, index) logit pairs per record (0: dense).
    top_k: int = 0

    def __post_init__(self):
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")


@dataclass(frozen=True)
class OnlineConfig:
    """Knobs of the online serve/train interleave (``repro_torch.serving``).

    ``enabled=False`` runs the pure serving loop. Enabled, each serve round's
    request batch (prompt + the decode continuation) is admitted into the
    rehearsal buffer and ``train_every`` pipelined train steps run after the
    round's decode; the updated weights are handed to serving at the round
    boundary."""

    enabled: bool = False
    rounds: int = 8  # serve rounds (one request batch each)
    requests_per_round: int = 4  # decode batch size per round
    prompt_len: int = 16  # request prefix fed through prefill
    # Greedy continuation length; 0 derives seq_len + 1 - prompt_len so the
    # admitted record (prompt ++ continuation, shifted) exactly fills the
    # scenario's [seq_len] token/label layout.
    gen_len: int = 0
    train_every: int = 1  # train steps interleaved per round (0 = serve-only)
    # Admit the decode continuation with the prompt; False stores the raw
    # request stream rows instead.
    store_decode: bool = True
    freshness_every: int = 0  # rounds between drifted-slice evals (0 = end only)

    def __post_init__(self):
        if self.rounds < 1:
            raise ValueError(f"rounds must be >= 1, got {self.rounds}")
        if self.prompt_len < 1:
            raise ValueError(f"prompt_len must be >= 1, got {self.prompt_len}")
        if self.gen_len < 0 or self.train_every < 0:
            raise ValueError("gen_len and train_every must be >= 0")

    def resolved_gen_len(self, seq_len: int) -> int:
        """Continuation length: explicit, else sized so that
        ``prompt_len + gen_len == seq_len + 1`` (record = shifted pair)."""
        if self.gen_len:
            return self.gen_len
        g = seq_len + 1 - self.prompt_len
        if g < 1:
            raise ValueError(
                f"prompt_len={self.prompt_len} leaves no room for a "
                f"continuation at seq_len={seq_len}")
        return g


@dataclass(frozen=True)
class ResilienceConfig:
    """Knobs of the fault-tolerant training loop (``runtime.ResilientLoop``).

    ``ContinualTrainer(resilience=...)`` wraps each task's step loop in a
    ``ResilientLoop``: periodic full-carry checkpoints and a cursor rewind give
    a bit-exact restart after a failure (the stream and every key are pure
    functions of (seed, step)), transient exceptions get bounded retry with
    exponential backoff, and a wall-clock step timeout feeds the
    ``StragglerPolicy`` bounded-staleness reuse path instead of blocking."""

    checkpoint_every: int = 25  # steps between periodic full-carry snapshots
    max_restarts: int = 3  # bounded retry: restarts beyond this re-raise
    backoff_base: float = 0.0  # s; restart r sleeps min(max, base * 2**(r-1))
    backoff_max: float = 30.0
    # Wall-clock step budget (seconds); a step exceeding it marks the next
    # step's exchange as straggling, and the trainer reuses the pending
    # representatives instead of waiting. 0 disables the timeout.
    step_timeout: float = 0.0
    straggler_delay_prob: float = 0.0  # simulated late-exchange probability
    max_staleness: int = 4  # bound on consecutive representative reuses
    # True: retry the transient set (``runtime.TRANSIENT_EXCEPTIONS``).
    # False: only InjectedFailure (chaos hooks) is retried.
    retry_transient: bool = True

    def __post_init__(self):
        if self.checkpoint_every < 1:
            raise ValueError(f"checkpoint_every must be >= 1, got {self.checkpoint_every}")
        if self.max_restarts < 0:
            raise ValueError(f"max_restarts must be >= 0, got {self.max_restarts}")


@dataclass(frozen=True)
class RunConfig:
    """Everything one run needs. ``model=None`` lets the scenario supply its
    default model (the reduced CNN)."""

    model: Optional[Any] = None  # CNNConfig | None (the LM path takes a ModelConfig directly)
    train: TrainConfig = TrainConfig()
    rehearsal: RehearsalConfig = RehearsalConfig()
    # Strategy hyper-parameters; the strategy name is ScenarioConfig.strategy.
    strategy: StrategyConfig = StrategyConfig()
    scenario: ScenarioConfig = ScenarioConfig()
    # None: no fault-tolerant loop; a ResilienceConfig turns on checkpointed
    # restart and bounded-staleness straggler handling in ContinualTrainer.
    resilience: Optional[ResilienceConfig] = None
    # Online continual serving (``repro_torch.serving.OnlineLearner``).
    online: OnlineConfig = OnlineConfig()
    # Pipeline race sanitizer (``runtime.sanitizer``): checks the one-step-
    # stale slot discipline on the host; values are bit-identical on or off.
    # Also armed by REPRO_SANITIZE=1.
    sanitize: bool = False

    def replace(self, **kw) -> "RunConfig":
        return dataclasses.replace(self, **kw)
