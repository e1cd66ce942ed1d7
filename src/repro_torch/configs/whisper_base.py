"""whisper-base [audio] — enc-dec, conv frontend (stub frame embeds).
[arXiv:2212.04356; unverified]"""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="whisper-base", family="encdec",
    n_layers=6, d_model=512, n_heads=8, n_kv_heads=8,
    d_ff=2048, vocab_size=51865,
    act="gelu", qkv_bias=True, rope_theta=0.0,  # learned positions, no rope
    n_enc_layers=6, n_frames=1500,
    source="arXiv:2212.04356",
)
