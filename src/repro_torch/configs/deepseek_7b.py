"""deepseek-7b — dense llama-arch [arXiv:2401.02954]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-7b", family="dense", n_layers=30, d_model=4096,
    n_heads=32, n_kv_heads=32, d_ff=11008, vocab=102400,
    source="arXiv:2401.02954 (DeepSeek LLM 7B)")

def reduced() -> ArchConfig:
    return ArchConfig(name="deepseek-7b-smoke", family="dense", n_layers=2,
                      d_model=256, n_heads=4, n_kv_heads=4, d_ff=512, vocab=512,
                      source=CONFIG.source)
