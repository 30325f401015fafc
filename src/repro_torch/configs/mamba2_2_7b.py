"""mamba2-2.7b — attention-free SSM, SSD (state-space duality) [arXiv:2405.21060]."""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-2.7b", family="ssm", n_layers=64, d_model=2560,
    n_heads=0, n_kv_heads=0, d_ff=0, vocab=50280,
    ssm=SSMConfig(d_state=128), source="arXiv:2405.21060 (Mamba-2 SSD)")

def reduced() -> ArchConfig:
    return ArchConfig(name="mamba2-smoke", family="ssm", n_layers=2,
                      d_model=256, n_heads=0, n_kv_heads=0, d_ff=0, vocab=512,
                      ssm=SSMConfig(d_state=16, head_dim=32, chunk_size=32),
                      source=CONFIG.source)
