"""qwen3-moe-30b-a3b [moe] — 128 experts top-8, qk_norm.
[hf:Qwen/Qwen3-30B-A3B; hf]"""
from repro_torch.configs import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4,
    d_ff=768, vocab_size=151936, head_dim=128,
    act="swiglu", qk_norm=True, rope_theta=1e6,
    moe=MoEConfig(n_experts=128, top_k=8, d_ff=768, every=1),
    source="hf:Qwen/Qwen3-30B-A3B",
)
