"""chameleon-34b — early-fusion VLM, VQ image tokens in vocab [arXiv:2405.09818].

The vision frontend (VQ-VAE tokenizer) is a stub: image patches arrive as
discrete tokens drawn from the shared vocab, so the backbone consumes one
token stream (early fusion).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="chameleon-34b", family="vlm", n_layers=48, d_model=8192,
    n_heads=64, n_kv_heads=8, d_ff=22016, vocab=65536, qk_norm=True,
    source="arXiv:2405.09818 (Chameleon)")

def reduced() -> ArchConfig:
    return ArchConfig(name="chameleon-34b-smoke", family="vlm", n_layers=2,
                      d_model=256, n_heads=4, n_kv_heads=2, d_ff=512, vocab=512,
                      qk_norm=True, source=CONFIG.source)
