"""seamless-m4t-medium — enc-dec multimodal (speech/text) [arXiv:2308.11596].

The mel-spectrogram + conv feature extractor frontend is a stub:
``input_specs`` provides precomputed frame embeddings (B, T_src, d_model).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium", family="audio", n_layers=12, d_model=1024,
    n_heads=16, n_kv_heads=16, d_ff=4096, vocab=256206,
    enc_layers=12, enc_input="audio_frames",
    source="arXiv:2308.11596 (SeamlessM4T medium)")

def reduced() -> ArchConfig:
    return ArchConfig(name="seamless-smoke", family="audio", n_layers=2,
                      d_model=256, n_heads=4, n_kv_heads=4, d_ff=512, vocab=512,
                      enc_layers=2, enc_input="audio_frames", source=CONFIG.source)
