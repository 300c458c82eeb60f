"""internvl2-1b: InternViT frontend (stub) + 24L LM backbone
[arXiv:2404.16821; hf].  Patch embeddings come precomputed via input_specs().
"""
import dataclasses
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2_1b", family="vlm", num_layers=24, d_model=896,
    num_heads=14, num_kv_heads=2, d_ff=4864, vocab_size=151655,
    frontend="vision", frontend_tokens=1024, qkv_bias=True,
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=56, num_heads=2, num_kv_heads=2,
        d_ff=112, vocab_size=256, frontend_tokens=16)
