"""llama4-maverick-400b-a17b — MoE 128e top-1, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E family card]."""
from repro_torch.configs.base import ArchConfig, MoEConfig

# MoE interleaved every second layer (dense FFN otherwise) — this is what
# makes 128e x top-1 total ~400B with ~17B active, as the model id states.
CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b", family="moe", n_layers=48, d_model=5120,
    n_heads=40, n_kv_heads=8, d_ff=8192, vocab=202048,
    moe=MoEConfig(n_experts=128, top_k=1, every_n=2), layer_pattern="AA",
    qk_norm=True, rope_theta=5e5,
    source="hf:meta-llama/Llama-4-Scout-17B-16E (family card)")

def reduced() -> ArchConfig:
    return ArchConfig(name="llama4-maverick-smoke", family="moe", n_layers=2,
                      d_model=256, n_heads=4, n_kv_heads=2, d_ff=256, vocab=512,
                      moe=MoEConfig(n_experts=4, top_k=1, every_n=2),
                      layer_pattern="AA", qk_norm=True,
                      source=CONFIG.source)
