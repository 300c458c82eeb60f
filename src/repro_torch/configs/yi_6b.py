"""yi-6b: llama-arch dense GQA [arXiv:2403.04652; hf]."""
import dataclasses
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="yi_6b", family="dense", num_layers=32, d_model=4096,
    num_heads=32, num_kv_heads=4, d_ff=11008, vocab_size=64000,
    tie_embeddings=False,
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=256)
