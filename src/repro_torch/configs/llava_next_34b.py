"""llava-next-34b [vlm] — anyres tiling (stub 576-patch prefix).
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]"""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-34b", family="vlm",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=20480, vocab_size=64000, head_dim=128,
    act="swiglu", rope_theta=1e6,
    n_patches=576,
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
)
