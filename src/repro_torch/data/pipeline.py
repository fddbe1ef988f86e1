"""Deterministic, stateless, sharded synthetic data pipeline
(``repro/data/pipeline.py``, in numpy as there: ``batch_at(step)`` gives
the reference's arrays bit for bit; the train launcher moves each batch to
the device).

``batch_at(step)`` is a pure function of (seed, step) — resumability and
elasticity fall out for free: after restore, training continues from step N
with bit-identical batches, on ANY dp width (the global batch is materialized
per-host by slicing, so re-sharding never changes the data order).  Real
deployments swap their tokenized corpus behind the same interface; everything
upstream (train loop, checkpoints, FT) only sees ``batch_at``.

The synthetic stream is a Zipf-ish token distribution with local n-gram
correlation so losses are non-trivial and compressible state appears in the
optimizer (exercises the lossy checkpoint path honestly).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from ..models.common import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq: int
    global_batch: int
    seed: int = 1234


class SyntheticLM:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def _tokens(self, step: int) -> np.ndarray:
        c = self.cfg
        rng = np.random.default_rng((int(c.seed) + int(step) * 0x9E3779B97F4A7C15) % (1 << 64))
        # zipf-ish marginal + markov smoothing for local structure
        base = rng.zipf(1.3, size=(c.global_batch, c.seq)).astype(np.int64)
        tok = base % c.vocab
        shift = np.roll(tok, 1, axis=1)
        mix = rng.random((c.global_batch, c.seq)) < 0.3
        tok = np.where(mix, (shift + 7) % c.vocab, tok)
        return tok.astype(np.int32)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        tok = self._tokens(step)
        labels = np.roll(tok, -1, axis=1)
        labels[:, -1] = -1  # no target for the last position
        return {"tokens": tok, "labels": labels}


class SyntheticEncDec(SyntheticLM):
    def __init__(self, cfg: DataConfig, enc_seq: int, d_model: int):
        super().__init__(cfg)
        self.enc_seq = enc_seq
        self.d_model = d_model

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        b = super().batch_at(step)
        rng = np.random.default_rng(self.cfg.seed * 31 + step)
        b["enc_frames"] = rng.standard_normal(
            (self.cfg.global_batch, self.enc_seq, self.d_model), np.float32
        )
        return b


class SyntheticVLM(SyntheticLM):
    def __init__(self, cfg: DataConfig, d_model: int):
        super().__init__(cfg)
        self.d_model = d_model

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        b = super().batch_at(step)
        rng = np.random.default_rng(self.cfg.seed * 17 + step)
        b["embeds"] = rng.standard_normal(
            (self.cfg.global_batch, self.cfg.seq, self.d_model), np.float32
        )
        del b["tokens"]
        return b


def make_pipeline(cfg: ModelConfig, seq: int, global_batch: int, seed: int = 1234):
    dc = DataConfig(vocab=cfg.vocab, seq=seq, global_batch=global_batch, seed=seed)
    if cfg.family == "encdec":
        return SyntheticEncDec(dc, cfg.enc_seq, cfg.d_model)
    if cfg.family == "vlm":
        return SyntheticVLM(dc, cfg.d_model)
    return SyntheticLM(dc)
