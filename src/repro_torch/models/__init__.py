"""Language models of the port: the serving path (prefill and decode) of
the dense decoders (GQA attention with its KV cache, RoPE, the MLP), of the
Mamba2 family, whose intra-chunk SSD term runs on the Hopper kernel
``kernels/csrc/ssd_intra.cu``, of the MoE models (the top-k router and
capacity dispatch), of the hybrid of all three, of the VLM backbone (a
stub vision frontend: patch embeddings in) and of the encoder-decoder model
(a stub audio frontend: frame embeddings in; cross-attention), and the
training loss of each (``loss_fn``), each under a sharding policy
(``Sharding``, ``make_policy``) with the specs of its parameters and caches
(``param_specs``, ``cache_specs``). The port of ``repro.models``."""

from .config import ArchConfig
from .layers import set_trainable
from .model import (
    LM,
    cache_specs,
    decode_step,
    forward,
    init_decode_state,
    init_params,
    loss_fn,
    param_specs,
)
from .sharding import NULL, Sharding, make_policy

__all__ = [
    "ArchConfig",
    "LM",
    "NULL",
    "Sharding",
    "cache_specs",
    "make_policy",
    "param_specs",
    "decode_step",
    "forward",
    "init_decode_state",
    "init_params",
    "loss_fn",
    "set_trainable",
]
