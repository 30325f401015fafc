"""stablelm-3b — dense [hf:stabilityai/stablelm-2-1_6b family]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-3b", family="dense", n_layers=32, d_model=2560,
    n_heads=32, n_kv_heads=32, d_ff=6912, vocab=50304,
    source="hf:stabilityai/stablelm-2-1_6b")

def reduced() -> ArchConfig:
    return ArchConfig(name="stablelm-3b-smoke", family="dense", n_layers=2,
                      d_model=256, n_heads=4, n_kv_heads=4, d_ff=512, vocab=512,
                      source=CONFIG.source)
