"""Architecture/shape config system.

Every assigned architecture is a module exposing ``CONFIG: ArchConfig``.
``get_config(name)`` resolves from the registry; ``--arch <id>`` in the
launchers goes through here.

A copy of the reference package's ``repro.configs`` (pure data), so that
the port imports nothing of ``repro``; the dense, MoE and mamba hybrid
families build in the port so far (``repro_torch.models.model_zoo``).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int                  # per-expert hidden dim
    every: int = 1             # MoE on layers where (idx % every == every-1)
    capacity_factor: float = 1.25
    group_size: int = 256      # tokens per dispatch group (bounds dispatch tensor)
    router_z_coef: float = 1e-3
    aux_coef: float = 1e-2


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0           # 0 => d_model // 16
    chunk: int = 256           # chunked selective-scan block


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int                  # dense-MLP hidden (per-expert dim lives in moe)
    vocab_size: int
    head_dim: int = 0          # 0 => d_model // n_heads
    act: str = "swiglu"        # swiglu | geglu | gelu
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 1e6
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    attn_every: int = 1        # hybrid: attention on layers where idx % attn_every == attn_every // 2
    n_enc_layers: int = 0      # encdec only
    n_frames: int = 0          # encdec audio frames (stub frontend)
    n_patches: int = 0         # vlm patch prefix (stub frontend)
    attn_free: bool = False    # rwkv: no attention at all
    source: str = ""           # provenance tag from the assignment table

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a TP/MXU-friendly multiple (loss masks the pad)."""
        m = 2048
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def dt_rank(self) -> int:
        assert self.ssm is not None
        return self.ssm.dt_rank or max(self.d_model // 16, 1)

    @property
    def full_attention(self) -> bool:
        """True when long-context decode is quadratic/full-KV (=> skip long_500k)."""
        return not (self.attn_free or self.attn_every > 1)

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs decode (whisper is enc-dec, not enc-only)

    def scaled(self, **overrides) -> "ArchConfig":
        """Reduced config of the same family for smoke tests."""
        return dataclasses.replace(self, **overrides)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                  # train | prefill | decode


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4096, 256, "train"),
    ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    ShapeConfig("decode_32k", 32768, 128, "decode"),
    ShapeConfig("long_500k", 524288, 1, "decode"),
)

SHAPES_BY_NAME = {s.name: s for s in SHAPES}

ARCH_IDS = (
    "glm4_9b",
    "qwen2_1_5b",
    "qwen3_8b",
    "gemma_7b",
    "llava_next_34b",
    "whisper_base",
    "jamba_v0_1_52b",
    "granite_moe_1b_a400m",
    "qwen3_moe_30b_a3b",
    "rwkv6_3b",
)

# public ids use dashes (assignment table); module names use underscores
def _norm(name: str) -> str:
    return name.replace("-", "_").replace(".", "_")


def get_config(name: str) -> ArchConfig:
    mod_name = _norm(name)
    if mod_name not in ARCH_IDS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCH_IDS)}")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG


def get_shape(name: str) -> ShapeConfig:
    return SHAPES_BY_NAME[name]


def all_configs():
    return {a: get_config(a) for a in ARCH_IDS}


def applicable_shapes(cfg: ArchConfig):
    """The (arch x shape) cells that are well-defined per the assignment rules."""
    out = []
    for s in SHAPES:
        if s.name == "long_500k" and cfg.full_attention:
            continue  # needs sub-quadratic attention; skip noted in DESIGN.md
        out.append(s)
    return tuple(out)
