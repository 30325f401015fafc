"""qwen3-14b — dense, qk_norm, GQA [hf:Qwen/Qwen3-8B card family]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-14b", family="dense", n_layers=40, d_model=5120,
    n_heads=40, n_kv_heads=8, d_ff=17408, vocab=151936, qk_norm=True,
    head_dim=128, rope_theta=1e6, source="hf:Qwen/Qwen3-8B (family card)")

def reduced() -> ArchConfig:
    return ArchConfig(name="qwen3-14b-smoke", family="dense", n_layers=2,
                      d_model=256, n_heads=4, n_kv_heads=2, d_ff=512, vocab=512,
                      qk_norm=True, head_dim=64, source=CONFIG.source)
