"""Deterministic synthetic token pipeline: shardable + exactly resumable.

A copy of ``repro/data/pipeline.py`` (numpy only): the same seed gives the
same batches in both packages, step for step, and after ``load_state_dict``.

Production shape: each host slices its batch rows from the global batch
(``host_slice``); the iterator state is one integer (step) + the seed, so a
restored checkpoint resumes the exact token stream (tested in
tests/test_torch_train.py).  Tokens follow a Zipfian-ish distribution over
the vocab with a repeating n-gram structure so tiny LMs have signal to fit
(loss decreases — used by the convergence-model experiments).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np


@dataclasses.dataclass
class DataState:
    seed: int
    step: int

    def to_dict(self) -> Dict:
        return {"seed": self.seed, "step": self.step}

    @classmethod
    def from_dict(cls, d: Dict) -> "DataState":
        return cls(int(d["seed"]), int(d["step"]))


class SyntheticTokens:
    """Next-token-prediction batches with learnable structure."""

    def __init__(self, vocab_size: int, seq_len: int, global_batch: int,
                 seed: int = 0, n_frontend: int = 0, d_model: int = 0,
                 ngram: int = 4):
        self.vocab = vocab_size
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.state = DataState(seed=seed, step=0)
        self.ngram = ngram
        self.n_frontend = n_frontend
        self.d_model = d_model
        # fixed "language": a random n-gram transition table
        rng = np.random.RandomState(seed + 101)
        self.table = rng.randint(0, vocab_size, size=(256,)).astype(np.int32)

    # ------------------------------------------------------------------
    def _batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.RandomState((self.state.seed * 1_000_003 + step)
                                    % (2 ** 31 - 1))
        b, s = self.global_batch, self.seq_len
        # zipf-ish marginals + deterministic n-gram continuation
        base = rng.zipf(1.3, size=(b, s)).astype(np.int64)
        tokens = (base % self.vocab).astype(np.int32)
        for t in range(self.ngram, s, self.ngram):
            ctx = tokens[:, t - 1] % 256
            tokens[:, t] = self.table[ctx]
        labels = np.concatenate([tokens[:, 1:], tokens[:, :1]], axis=1)
        out = {"tokens": tokens, "labels": labels}
        if self.n_frontend:
            out["frontend_embeds"] = rng.randn(
                b, self.n_frontend, self.d_model).astype(np.float32) * 0.02
        return out

    def next_batch(self) -> Dict[str, np.ndarray]:
        batch = self._batch_at(self.state.step)
        self.state.step += 1
        return batch

    def host_slice(self, batch: Dict[str, np.ndarray], host_id: int,
                   n_hosts: int) -> Dict[str, np.ndarray]:
        per = self.global_batch // n_hosts
        sl = slice(host_id * per, (host_id + 1) * per)
        return {k: v[sl] for k, v in batch.items()}

    # ------------------------------------------------------------------
    def state_dict(self) -> Dict:
        return self.state.to_dict()

    def load_state_dict(self, d: Dict) -> None:
        self.state = DataState.from_dict(d)
