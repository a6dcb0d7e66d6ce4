"""Architecture-agnostic transformer configuration (own copy of
``repro.models.transformer.config``, which imports no JAX).

One dataclass covers the assigned families via a repeating
``layer_pattern`` (the unit the reference scans over): e.g.
  ["attn", "mlp"] x24                      -> llama4 (moe every other layer
  ["attn", "moe"]                              is expressed in the pattern)
  ["attn", "moe"] x94/2                    -> qwen3-moe (every layer moe)
  ["mamba"] x48                            -> mamba2
  ["attn_local", "attn_global"] x13        -> gemma2 alternation
  ["mamba"]*6 + ["shared_attn"]            -> zamba2 groups
Block kinds: attn, attn_local, attn_global, shared_attn, xattn, mamba —
each implicitly followed by its mixer (mlp/moe) according to ``mixer_of``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int                 # per-expert FFN hidden dim
    shared_expert: bool = False   # llama4-style always-on shared expert
    capacity_factor: float = 1.25
    # LABOR-inspired variance-matched Poisson token subsampling instead of
    # positional truncation when an expert overflows capacity (beyond-paper,
    # see DESIGN.md §Arch-applicability). Off by default.
    poisson_capacity: bool = False
    router_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 128


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    num_layers: int                      # total layers = len(pattern)*repeats
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int

    # repeating structural unit; scan runs over `repeats` copies of it
    layer_pattern: Tuple[str, ...] = ("attn",)
    # mixer after each attention-ish block: "mlp" | "moe" | "none",
    # one per pattern entry
    mixers: Optional[Tuple[str, ...]] = None

    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None

    # attention details
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0           # stablelm partial rotary
    attn_softcap: Optional[float] = None  # gemma2
    final_softcap: Optional[float] = None
    window: Optional[int] = None          # sliding window for attn_local
    query_scale: Optional[float] = None   # override 1/sqrt(head_dim)
    # "heads": Megatron TP over (padded) head dim. "sequence": context-
    # parallel attention — queries sharded over S, K/V gathered, attention
    # weights replicated over the TP axis. The right choice when
    # n_heads % TP != 0 (gemma2: 8 heads on a 16-way axis would be padded
    # 2x and constantly resharded). §Perf iteration.
    attn_parallelism: str = "heads"

    # cross attention (vlm / enc-dec decoder)
    xattn_every: Optional[int] = None     # insert xattn block every N layers
    xattn_source_len: int = 0             # encoder/vision sequence length
    xattn_source_dim: Optional[int] = None

    # encoder (whisper): a second stack config
    encoder: Optional["TransformerConfig"] = None
    is_encoder: bool = False              # no causal mask, no decode step

    norm: str = "rmsnorm"                 # rmsnorm | layernorm
    post_norms: bool = False              # gemma2 post-block norms
    activation: str = "silu"              # silu | gelu | relu2
    gated_mlp: bool = True                # False: plain 2-matrix MLP (whisper)
    tie_embeddings: bool = True
    embed_scale: bool = False             # gemma2 sqrt(d) embedding scale
    logit_dtype: str = "float32"

    dtype: str = "bfloat16"               # activation/param dtype on TPU
    remat: bool = True
    remat_policy: str = "full"            # full | dots (save matmul outputs)
    scan_layers: bool = True
    # §Perf: store the residual scan carry sequence-sharded over the TP
    # axis (Megatron-SP style): carry HBM /TP at the cost of one
    # all-gather per group — lets the microbatch count (and with it the
    # per-step FSDP re-gather traffic) drop by ~TP x.
    seq_shard_carry: bool = False

    @property
    def repeats(self) -> int:
        assert self.num_layers % len(self.layer_pattern) == 0, (
            f"{self.name}: {self.num_layers} layers not divisible by "
            f"pattern of {len(self.layer_pattern)}"
        )
        return self.num_layers // len(self.layer_pattern)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def mixer_for(self, i: int) -> str:
        if self.mixers is not None:
            return self.mixers[i]
        kind = self.layer_pattern[i]
        return "none" if kind == "mamba" else "mlp"

    def has_block(self, kind: str) -> bool:
        return kind in self.layer_pattern


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One assigned (arch x shape) cell."""
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


LM_SHAPES: Tuple[ShapeSpec, ...] = (
    ShapeSpec("train_4k", 4096, 256, "train"),
    ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    ShapeSpec("decode_32k", 32768, 128, "decode"),
    ShapeSpec("long_500k", 524288, 1, "decode"),
)


def shape_by_name(name: str) -> ShapeSpec:
    for s in LM_SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)
