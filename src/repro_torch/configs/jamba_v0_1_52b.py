"""jamba-v0.1-52b — hybrid Mamba+attention 1:7 interleave, MoE 16e top-2
[arXiv:2403.19887]. Every block carries an FFN; every other FFN is MoE
(the published model applies MoE at every second layer)."""
from repro_torch.configs.base import ArchConfig, MoEConfig, SSMConfig

# Jamba block pattern: 8 layers per block, attention at index 4 -> 1:7 ratio.
_PATTERN = "MMMMAMMM"

CONFIG = ArchConfig(
    name="jamba-v0.1-52b", family="hybrid", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=8, d_ff=14336, vocab=65536,
    moe=MoEConfig(n_experts=16, top_k=2, every_n=2),
    ssm=SSMConfig(d_state=16, head_dim=64), layer_pattern=_PATTERN,
    source="arXiv:2403.19887 (Jamba)")

def reduced() -> ArchConfig:
    return ArchConfig(name="jamba-smoke", family="hybrid", n_layers=2,
                      d_model=256, n_heads=4, n_kv_heads=2, d_ff=256, vocab=512,
                      moe=MoEConfig(n_experts=4, top_k=2, every_n=2),
                      ssm=SSMConfig(d_state=16, head_dim=32, chunk_size=32),
                      layer_pattern="MA", source=CONFIG.source)
