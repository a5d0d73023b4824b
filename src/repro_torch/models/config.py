"""Architecture and run-shape configuration of the language models: a copy
of the reference's ``repro/models/config.py`` (``ArchConfig``, ``RunShape``,
``SHAPES``; pure arithmetic, kept equal to it field for field and count for
count)."""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Literal

Family = Literal["dense", "moe", "ssm", "hybrid", "encdec", "vlm"]


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 -> d_model // n_heads
    qkv_bias: bool = False
    act: str = "silu_glu"       # silu_glu | sq_relu | gelu
    norm: str = "rmsnorm"       # rmsnorm | layernorm
    tie_embeddings: bool = False
    rope_theta: float = 1e4
    mrope: bool = False         # qwen2-vl M-RoPE (3-section rotary)

    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0           # per-expert hidden dim (if MoE)
    moe_every: int = 1          # MoE in layers where (layer % moe_every)==moe_offset
    moe_offset: int = 0
    router_dtype: str = "float32"

    # SSM / Mamba2 (SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 256
    attn_every: int = 0         # hybrid: attention at layers where
    attn_offset: int = 0        #   (layer % attn_every) == attn_offset

    # encoder-decoder (whisper-style)
    is_encdec: bool = False
    dec_layers: int = 0
    max_target_len: int = 448

    # modality frontend stub: inputs are precomputed frame/patch embeddings
    frontend: str = "none"      # none | audio_stub | vision_stub

    dtype: str = "bfloat16"
    remat: str = "full"         # full | dots | none
    scan_layers: bool = True

    # ------------------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Embedding-table rows padded to 256 for clean vocab sharding
        (standard practice; logits beyond vocab_size are masked to -inf)."""
        return ((self.vocab_size + 255) // 256) * 256

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def is_attn_layer(self, layer: int) -> bool:
        if self.family == "ssm":
            return False
        if self.attn_every:
            return layer % self.attn_every == self.attn_offset
        return True

    def is_moe_layer(self, layer: int) -> bool:
        if not self.n_experts:
            return False
        return layer % self.moe_every == self.moe_offset

    @property
    def block_period(self) -> int:
        """Length of the repeating layer pattern (scan unit)."""
        p = 1
        if self.attn_every:
            p = self.attn_every
        if self.n_experts:
            p = int(p * self.moe_every / math.gcd(p, self.moe_every))
        return p

    # -------------------------------------------------------- param counts
    def param_count(self) -> int:
        d, v = self.d_model, self.vocab_size
        total = v * d  # embedding
        if not self.tie_embeddings:
            total += v * d
        total += d  # final norm
        n_dec = self.dec_layers if self.is_encdec else 0
        for layer in range(self.n_layers):
            total += self._layer_params(layer)
        for layer in range(n_dec):
            total += self._layer_params(layer) + self._attn_params() + self.d_model
        return total

    def _attn_params(self) -> int:
        d, hd = self.d_model, self.hd
        q = d * self.n_heads * hd
        kv = 2 * d * self.n_kv_heads * hd
        o = self.n_heads * hd * d
        b = (self.n_heads + 2 * self.n_kv_heads) * hd if self.qkv_bias else 0
        return q + kv + o + b

    def _mlp_params(self, d_ff: int) -> int:
        d = self.d_model
        mult = 3 if self.act == "silu_glu" else 2
        return mult * d * d_ff

    def _ssm_params(self) -> int:
        d, di, n = self.d_model, self.d_inner, self.ssm_state
        h = self.ssm_heads
        in_proj = d * (2 * di + 2 * n + h)  # z, x, B, C, dt
        conv = (di + 2 * n) * self.ssm_conv
        out = di * d
        extras = 3 * h  # A_log, D, dt_bias
        extras += di  # gated norm
        return in_proj + conv + out + extras

    def _layer_params(self, layer: int) -> int:
        total = 2 * self.d_model  # norms
        if self.is_attn_layer(layer):
            total += self._attn_params()
        elif self.family in ("ssm", "hybrid"):
            total += self._ssm_params()
        if self.is_moe_layer(layer):
            total += self.n_experts * self._mlp_params(self.moe_d_ff)
            total += self.d_model * self.n_experts  # router
        elif self.d_ff:
            total += self._mlp_params(self.d_ff)
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k of n_experts)."""
        if not self.n_experts:
            return self.param_count()
        total = self.param_count()
        for layer in range(self.n_layers):
            if self.is_moe_layer(layer):
                inactive = (self.n_experts - self.top_k) * self._mlp_params(
                    self.moe_d_ff
                )
                total -= inactive
        return total


@dataclass(frozen=True)
class RunShape:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]
    microbatch: int = 0  # 0 -> no gradient accumulation; else per-device
                         # batch is split into chunks of this many sequences


SHAPES: dict[str, RunShape] = {
    "train_4k": RunShape("train_4k", 4096, 256, "train"),
    "prefill_32k": RunShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": RunShape("decode_32k", 32768, 128, "decode"),
    "long_500k": RunShape("long_500k", 524288, 1, "decode"),
}
