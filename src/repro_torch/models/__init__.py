"""Language models of the port: the Mamba2 family's serving path (prefill
and decode), its intra-chunk SSD term on the Hopper kernel
``kernels/csrc/ssd_intra.cu``. The port of ``repro.models``; the other
families wait (ROADMAP Queue 1 item 15)."""

from .config import ArchConfig
from .model import LM, decode_step, forward, init_decode_state, init_params

__all__ = [
    "ArchConfig",
    "LM",
    "decode_step",
    "forward",
    "init_decode_state",
    "init_params",
]
