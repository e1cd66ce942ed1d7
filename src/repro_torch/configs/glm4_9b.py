"""glm4-9b [dense] — RoPE, GQA kv=2. [hf:THUDM/glm-4-9b; hf]"""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="glm4-9b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=2,
    d_ff=13696, vocab_size=151552,
    act="swiglu", rope_theta=1e6,
    source="hf:THUDM/glm-4-9b",
)
