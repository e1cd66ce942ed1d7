"""rwkv6-3b [ssm] — Finch, data-dependent decay, attn-free.
[arXiv:2404.05892; hf]"""
from repro_torch.configs import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="rwkv6-3b", family="ssm",
    n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40,  # wkv heads, head_dim=64
    d_ff=8960, vocab_size=65536, head_dim=64,
    act="relu_sq",  # rwkv channel-mix uses squared relu
    rope_theta=0.0,
    ssm=SSMConfig(chunk=64),
    attn_free=True,
    source="arXiv:2404.05892",
)
