"""qwen2.5-32b — dense, GQA, QKV bias [hf:Qwen/Qwen2.5-0.5B card family]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-32b", family="dense", n_layers=64, d_model=5120,
    n_heads=40, n_kv_heads=8, d_ff=27648, vocab=152064, qkv_bias=True,
    rope_theta=1e6, source="hf:Qwen/Qwen2.5-0.5B (family card)")

def reduced() -> ArchConfig:
    return ArchConfig(name="qwen2.5-32b-smoke", family="dense", n_layers=2,
                      d_model=256, n_heads=4, n_kv_heads=2, d_ff=512, vocab=512,
                      qkv_bias=True, source=CONFIG.source)
