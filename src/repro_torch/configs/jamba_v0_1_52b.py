"""jamba-v0.1-52b [hybrid] — Mamba+attn 1:7 interleave, MoE 16e top-2
every other layer. [arXiv:2403.19887; hf]"""
from repro_torch.configs import ArchConfig, MoEConfig, SSMConfig

CONFIG = ArchConfig(
    name="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab_size=65536,
    act="swiglu", rope_theta=0.0,  # jamba attn layers use no positional encoding
    moe=MoEConfig(n_experts=16, top_k=2, d_ff=14336, every=2),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
    attn_every=8,
    source="arXiv:2403.19887",
)
