"""Counter-indexed synthetic LM data (see the package docstring), the port
of ``repro/data/pipeline.py``.

The "corpus" is a fixed random Markov-ish token process: token t+1 is the
bigram table's successor of token t with probability ``structure``, else
noise, giving the model structure to learn while staying deterministic
and storage-free. The bigram table is the reference's (numpy, so equal).
The starts, the noise and the chain choice come from a CPU
``torch.Generator`` seeded from (seed, step): JAX's PRNG cannot be
reproduced, so the tokens are not the reference's (``docs/PORT.md``), but
they are the same on every device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np
import torch

from ..engine.context import check_device


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    structure: float = 0.8  # probability a token follows the bigram chain


def _bigram_table(vocab: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, size=(vocab,), dtype=np.int32)


def _generator(seed: int, step: int) -> torch.Generator:
    """A CPU generator whose seed mixes (seed, step)."""
    mixed = np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0]
    return torch.Generator().manual_seed(int(mixed))


def synthetic_batch(cfg: DataConfig, step: int, device="cuda") -> dict:
    """Global batch for ``step`` (a pure function of (cfg.seed, step)):
    ``tokens`` and next-token ``labels`` (wrapping at the end), (B, S)
    int64 on ``device``."""
    dev = check_device(device, "synthetic_batch")
    gen = _generator(cfg.seed, step)
    b, s, v = cfg.global_batch, cfg.seq_len, cfg.vocab_size
    table = torch.from_numpy(_bigram_table(v, cfg.seed)).long()
    start = torch.randint(0, v, (b,), generator=gen)
    noise = torch.randint(0, v, (b, s), generator=gen)
    use_chain = torch.rand((b, s), generator=gen) < cfg.structure
    tokens = torch.empty((b, s), dtype=torch.int64)
    tok = start
    for t in range(s):
        tok = torch.where(use_chain[:, t], table[tok], noise[:, t])
        tokens[:, t] = tok
    labels = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)  # next-token targets
    return {"tokens": tokens.to(dev), "labels": labels.to(dev)}


def batch_iterator(cfg: DataConfig, start_step: int = 0, device="cuda"
                   ) -> Iterator[tuple[int, dict]]:
    """Resumable iterator: pass the restored step after a restart."""
    step = start_step
    while True:
        yield step, synthetic_batch(cfg, step, device)
        step += 1
