"""granite-moe-1b-a400m — 32 experts top-8 [hf:ibm-granite/granite-3.0-1b-a400m-base]."""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="granite-moe-1b-a400m", family="moe", n_layers=24, d_model=1024,
    n_heads=16, n_kv_heads=8, d_ff=512, vocab=49155,
    moe=MoEConfig(n_experts=32, top_k=8),
    source="hf:ibm-granite/granite-3.0-1b-a400m-base")

def reduced() -> ArchConfig:
    return ArchConfig(name="granite-moe-smoke", family="moe", n_layers=2,
                      d_model=256, n_heads=4, n_kv_heads=2, d_ff=128, vocab=512,
                      moe=MoEConfig(n_experts=4, top_k=2), source=CONFIG.source)
