"""Architecture and shape configuration (the port's copy of
``repro.configs.base``; it imports nothing of the JAX package).

One ``ArchConfig`` per architecture (``repro_torch/configs/<id>.py``), a
``ShapeConfig`` per input shape, and the registry the launchers read
(``--arch <id>``): every architecture of the reference, each config equal
field for field to the reference's.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | ssm | vlm | hybrid | audio | moe
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 -> d_model // num_heads
    rope_style: str = "full"     # full | glm2d (rotary on half the dims)
    qkv_bias: bool = False
    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    # SSM (rwkv6 / mamba2)
    ssm_state: int = 0
    ssm_kind: str = "none"       # none | rwkv6 | mamba2
    # hybrid (zamba2): one *shared* attention block applied every k layers
    hybrid_attn_every: int = 0
    # enc-dec (seamless): encoder layer count; decoder = num_layers
    encoder_layers: int = 0
    # modality frontend stub
    frontend: str = "none"       # none | vision | audio
    frontend_tokens: int = 0
    tie_embeddings: bool = True
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to 512 (e.g. granite's 49155 -> 49664); padded
        logit columns are masked to -1e30."""
        return ((self.vocab_size + 511) // 512) * 512

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def attention_free(self) -> bool:
        return self.ssm_kind == "rwkv6"

    def param_count(self) -> int:
        """Analytic parameter count (the reference's formula)."""
        d, f, v, hd = self.d_model, self.d_ff, self.vocab_size, self.hd
        attn = d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd \
            + self.num_heads * hd * d
        if self.qkv_bias:
            attn += (self.num_heads + 2 * self.num_kv_heads) * hd
        if self.is_moe:
            mlp = self.num_experts * 3 * d * f + d * self.num_experts
        else:
            mlp = 3 * d * f
        norms = 2 * d
        if self.ssm_kind == "rwkv6":
            dh = self.num_heads * hd
            layer = 5 * d * dh + dh * d + 3 * d * f + norms
        elif self.ssm_kind == "mamba2":
            di = 2 * d
            layer = d * (2 * di + 2 * self.ssm_state) + di * d + norms
            if not self.hybrid_attn_every:
                layer += 3 * d * f
        else:
            layer = attn + mlp + norms
        total = self.num_layers * layer
        if self.ssm_kind == "mamba2" and self.hybrid_attn_every:
            total += attn + 3 * d * f + norms
        if self.is_encdec:
            enc_layer = attn + 3 * d * f + norms
            cross = attn + norms
            total += self.encoder_layers * enc_layer + self.num_layers * cross
        total += v * d
        if not self.tie_embeddings:
            total += v * d
        return int(total)

    def active_param_count(self) -> int:
        """MoE: params touched per token (6 N_active D)."""
        if not self.is_moe:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        dense = self.param_count() - self.num_layers * self.num_experts * 3 * d * f
        return int(dense + self.num_layers * self.experts_per_token * 3 * d * f)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

ARCH_IDS = [
    "yi_6b", "qwen2_5_14b", "granite_3_2b", "chatglm3_6b", "rwkv6_3b",
    "internvl2_1b", "zamba2_7b", "seamless_m4t_medium", "qwen3_moe_235b_a22b",
    "granite_moe_1b_a400m",
]


def get_config(name: str) -> ArchConfig:
    mod = importlib.import_module(f"repro_torch.configs.{name.replace('-', '_')}")
    return mod.CONFIG


def get_reduced(name: str) -> ArchConfig:
    mod = importlib.import_module(f"repro_torch.configs.{name.replace('-', '_')}")
    return mod.reduced()
