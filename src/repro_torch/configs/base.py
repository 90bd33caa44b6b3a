"""Config system: frozen dataclasses, hashable (usable as memo keys)."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab_size: int = 32000
    qkv_bias: bool = False
    ffn_gated: bool = True             # False = plain 2-matrix GELU MLP
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    # --- MoE ---
    num_experts: int = 0
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0
    moe_dense_residual: bool = False   # arctic: parallel dense FFN residual
    d_ff_expert: int = 0
    router_aux_coef: float = 0.01
    capacity_factor: float = 1.25
    moe_group_size: int = 1024         # tokens per dispatch group (chunked MoE)
    moe_dispatch: str = "einsum"       # einsum (GShard one-hot) | sort (beyond-paper)
    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 64
    ssm_groups: int = 1
    # --- hybrid (zamba2) ---
    attn_every: int = 0                # shared attn+mlp block every k layers
    # --- attention windowing ---
    sliding_window: int = 0            # 0 = full causal
    # --- modality frontends (stubs per spec carve-out) ---
    num_patches: int = 0               # vlm: prefix patch embeds per sample
    frontend: str = "none"             # none | vision_stub | audio_stub
    # --- numerics / training ---
    dtype: str = "bfloat16"
    remat: str = "full"                # none | dots | full
    scan_layers: bool = True
    force_bf16_grads: bool = False     # cast residual-stream cotangents to bf16
                                       # before TP all-reduces (beyond-paper)
    use_pallas: bool = False           # TPU kernels (CPU dry-run uses jnp path)

    @property
    def d_inner(self) -> int:          # mamba2 inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    """One of the four assigned input shapes."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                 # "train" | "prefill" | "decode"

    def replace(self, **kw) -> "ShapeConfig":
        return dataclasses.replace(self, **kw)


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


@dataclass(frozen=True)
class OptimConfig:
    name: str = "adamw"        # sgd | momentum | adamw
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    momentum: float = 0.9
    state_dtype: str = "float32"   # adam moments dtype (bf16 for huge models)


@dataclass(frozen=True)
class MeshConfig:
    data: int = 16
    model: int = 16
    pods: int = 1

    @property
    def n_devices(self) -> int:
        return self.data * self.model * self.pods


@dataclass(frozen=True)
class FLConfig:
    """Generalized AsyncSGD scheduling config (the paper's knobs).

    The queueing knobs (``n_clients`` .. ``speed_ratio``) parameterize the
    closed Jackson network of §2 and the client-speed heterogeneity of the
    §5 experiment; the engine knobs (``engine`` .. ``devices``) pick how the
    server loop executes — see ``docs/architecture.md`` for the full
    host/device/blocked runner decision matrix, and
    `repro.core.async_sgd.ServerConfig` for the per-run equivalent these
    fields translate into (`repro.fl.engine.run_experiment`).
    """

    n_clients: int = 100           # n — number of federated clients
    concurrency: int = 10          # C — tasks in flight (closed-network pop.)
    server_steps: int = 200        # T — CS steps (one completion+dispatch each)
    sampling: str = "optimal"      # client-sampling policy for p:
                                   # uniform | optimal (Theorem-1 bound
                                   # minimizer) | physical_time
    service: str = "exp"           # service law: "exp" | "det" (host-only)
    frac_fast: float = 0.5         # fraction of fast clients (two clusters)
    speed_ratio: float = 10.0      # mu_fast / mu_slow
    weighting: str = "importance"  # importance (Alg. 1) | plain
    fedbuff_Z: int = 10            # FedBuff buffer size (flush every Z-th)
    seed: int = 0
    engine: str = "python"         # python (reference loop) | scan (compiled)
    stream: str = "host"           # scan event source: host (pre-simulated
                                   # replay) | device (fused on-device
                                   # generator — zero host pre-simulation)
    sparse: bool | str = "auto"    # device stream: sparse O(C) stream state
                                   # for large n (see ServerConfig.sparse) —
                                   # "auto" switches on above SPARSE_AUTO_N
                                   # when the speed profile collapses to few
                                   # classes; True forces, False keeps dense
    adaptive: bool = False         # device stream: adaptive sampling control
                                   # loop (re-optimize p from observed queues)
    refresh_every: int = 250       # control-loop cadence in CS steps
    block_size: int | str = 1      # scan engine: events per micro-block
                                   # (E > 1 = blocked replay; exact — see
                                   # engine_scan / docs); "auto" picks E from
                                   # measured conflict rates
                                   # (queue_sim.select_block_size)
    devices: int = 1               # blocked engine: lane-shard device count —
                                   # each micro-block's E gradient lanes are
                                   # split across this many devices (requires
                                   # block_size a >1 multiple of it)
    segmentation: str = "greedy"   # blocked cut placement: greedy | dp
                                   # (queue_sim.segment_blocks)
    scenario: str | None = None    # scenario-registry name (core.scenario.
                                   # SCENARIOS): phase-type service + Markov-
                                   # modulated availability; None or
                                   # "exponential" keeps the paper's exp/
                                   # always-on law (bitwise-identical engine
                                   # path)
    device: str = "cuda"           # torch device of the run ("cuda" raises
                                   # when no card is visible; tests pass
                                   # "cpu")

    def replace(self, **kw) -> "FLConfig":
        return dataclasses.replace(self, **kw)
