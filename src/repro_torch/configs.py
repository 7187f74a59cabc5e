"""GNN and training configs (`repro/configs/base.py:162-212`) and the
paper's model configs: GraphSAGE (`repro/configs/graphsage.py`), and GCN
and GAT at the same widths (`repro/configs/gcn.py`, `gat.py`). The LM
side's `ModelConfig` (`repro/configs/base.py:22-132`, copied whole) and
the LM configs ported so far (`LM_CONFIGS`: gemma3-1b,
`repro/configs/gemma3_1b.py`; qwen2-moe-a2.7b,
`repro/configs/qwen2_moe_a27b.py`).

`GNNConfig` drops the reference's `agg_impl` knob: the port dispatches the
gather-aggregate by the tensor's device (the hand-written kernel on CUDA,
the plain PyTorch version on the CPU). `TrainConfig` has the GNN trainer's
fields and the LM trainer's extras (`grad_clip`, `microbatches`, `remat`,
`grad_compression`) with the reference's defaults.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, replace
from typing import Tuple


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class GNNConfig:
    name: str
    model: str = "sage"              # sage | gcn | gat
    num_layers: int = 3
    hidden_dim: int = 256
    in_dim: int = 602
    num_classes: int = 41
    fanout: Tuple[int, ...] = (10, 10, 10)
    gat_heads: int = 4
    dropout: float = 0.5
    dtype: str = "float32"


@dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 1024
    learning_rate: float = 1e-3
    weight_decay: float = 5e-4
    max_epochs: int = 100
    early_stop_patience: int = 6
    plateau_patience: int = 3
    plateau_factor: float = 0.1
    seed: int = 0
    # LM trainer extras
    grad_clip: float = 1.0
    microbatches: int = 1
    remat: bool = True
    grad_compression: bool = False


# Paper §5: DGL reference defaults (batch=1024, fanout=10, lr=1e-3,
# weight_decay=5e-4, hidden=256) — the paper's primary model.
CONFIG = GNNConfig(
    name="graphsage",
    model="sage",
    num_layers=3,
    hidden_dim=256,
    in_dim=602,                   # reddit-like
    num_classes=41,
    fanout=(10, 10, 10),
)

# Paper §6.4 generalisation study: GCN and GAT at the GraphSAGE widths.
GCN = replace(CONFIG, name="gcn", model="gcn")
GAT = replace(CONFIG, name="gat", model="gat", gat_heads=4)

CONFIGS = {c.name: c for c in (CONFIG, GCN, GAT)}


# ---------------------------------------------------------------------------
# LM-family model config (`repro/configs/base.py:22-132`)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # --- attention flavor -------------------------------------------------
    attention: str = "full"          # full | sliding | mixed | none
    window: int = 1024               # sliding-window size (mixed/sliding)
    global_every: int = 6            # in "mixed": every Nth layer is global
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 1e4
    mrope: bool = False              # 3-axis multimodal RoPE (qwen2-vl)
    mrope_sections: Tuple[int, ...] = (16, 24, 24)   # t/h/w split of head_dim/2

    # --- MoE ---------------------------------------------------------------
    moe: bool = False
    num_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    shared_d_ff: int = 0             # qwen2-moe shared expert
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.001

    # --- SSM / RWKV ---------------------------------------------------------
    ssm_state: int = 0               # mamba-style state size (hymba)
    rwkv: bool = False               # attention-free RWKV6 token mixing
    hybrid: bool = False             # parallel attn + SSM heads (hymba)

    # --- encoder-decoder (whisper) -----------------------------------------
    encoder_decoder: bool = False
    num_encoder_layers: int = 0
    encoder_seq: int = 1500          # whisper: 30s @ 50Hz post-conv frames

    # --- VLM stub ------------------------------------------------------------
    vision_tokens: int = 0           # leading positions carrying patch embeds

    # --- misc ----------------------------------------------------------------
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    act: str = "silu"                # silu | gelu
    norm: str = "rmsnorm"            # rmsnorm | layernorm (whisper)
    mlp_bias: bool = False           # whisper uses biased linears
    learned_pos: bool = False        # whisper decoder positions
    logit_softcap: float = 0.0       # gemma-style tanh soft-capping (unused=0)
    dtype: str = "bfloat16"          # compute dtype

    # -----------------------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 so TP-16/32 sharding divides."""
        return _round_up(self.vocab_size, 256)

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def is_global_layer(self, i: int) -> bool:
        if self.attention == "full":
            return True
        if self.attention == "sliding":
            return False
        # "mixed": gemma3 pattern — every `global_every`-th layer is global
        return (i % self.global_every) == (self.global_every - 1)

    def scaled(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ModelConfig":
        """Tiny same-family variant for CPU smoke tests."""
        heads = min(self.num_heads, 4)
        kv = max(1, min(self.num_kv_heads, heads))
        # keep GQA ratio flavor: if original had kv < heads, keep kv < heads
        if self.num_kv_heads < self.num_heads:
            kv = max(1, heads // 2)
        kw = dict(
            name=self.name + "-smoke",
            num_layers=min(self.num_layers, 4),
            d_model=64,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=16,
            d_ff=128,
            vocab_size=512,
            window=16,
            global_every=2,
            encoder_seq=24,
        )
        if self.moe:
            kw.update(num_experts=min(self.num_experts, 8),
                      top_k=min(self.top_k, 2), moe_d_ff=32,
                      shared_d_ff=64 if self.shared_d_ff else 0)
        if self.num_encoder_layers:
            kw.update(num_encoder_layers=2)
        if self.ssm_state:
            kw.update(ssm_state=4)
        if self.vision_tokens:
            kw.update(vision_tokens=8)
        if self.mrope:
            kw.update(mrope_sections=(2, 3, 3))   # half of head_dim 16
        return self.scaled(**kw)


# gemma3-1b [dense] — 5:1 local:global attention. [hf:google/gemma-3-1b-pt]
# (`repro/configs/gemma3_1b.py`)
GEMMA3_1B = ModelConfig(
    name="gemma3-1b",
    family="dense",
    num_layers=26,
    d_model=1152,
    num_heads=4,
    num_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab_size=262144,
    attention="mixed",
    window=512,
    global_every=6,
    qk_norm=True,
    rope_theta=10_000.0,
    tie_embeddings=True,
    act="gelu",
)

# qwen2-moe-a2.7b [moe] — 60 routed experts top-4 + shared expert.
# [hf:Qwen/Qwen1.5-MoE-A2.7B] (`repro/configs/qwen2_moe_a27b.py`)
QWEN2_MOE_A27B = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,                    # = moe expert ff (per assignment)
    vocab_size=151936,
    attention="full",
    qkv_bias=True,
    rope_theta=1_000_000.0,
    moe=True,
    num_experts=60,
    top_k=4,
    moe_d_ff=1408,
    shared_d_ff=5632,             # "4 shared" = one shared expert of 4x width
    act="silu",
)

# rwkv6-7b "Finch" [ssm] — attention-free, data-dependent decay.
# [arXiv:2404.05892] (`repro/configs/rwkv6_7b.py`)
RWKV6_7B = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    num_layers=32,
    d_model=4096,
    num_heads=64,                 # wkv heads, head_dim 64
    num_kv_heads=64,
    head_dim=64,
    d_ff=14336,
    vocab_size=65536,
    attention="none",
    rwkv=True,
    act="relu2",                  # rwkv channel-mix uses relu^2
)

LM_CONFIGS = {c.name: c for c in (GEMMA3_1B, QWEN2_MOE_A27B, RWKV6_7B)}
