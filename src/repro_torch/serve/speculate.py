"""Draft proposal for speculative multi-token decode (no second model).

Drafts come from *prompt lookup* (n-gram self-continuation): the proposer
searches the request's own prompt + generated tokens for the most recent
earlier occurrence of the current tail n-gram and proposes the tokens that
followed it.  When the request's own context has no match, the hash-chain
prefix cache is consulted the same way across the *other* stored prompts
(cross-request drafting) — common instruction heads make one request's
continuation a good draft for another's.

The proposer never influences the committed tokens, only how many target
steps they cost: every draft is verified by one batched target step over the
paged pools and accepted only as the longest prefix that matches what greedy
decode would have produced anyway (see ServeEngine.step and DESIGN.md §11).
A wrong draft therefore costs compute, never correctness — which is why a
cheap heuristic proposer is enough.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.serve.prefix import PrefixCache


def find_last_ngram(hay: np.ndarray, needle: np.ndarray) -> int:
    """Index of the last occurrence of ``needle`` in ``hay`` (or -1)."""
    n = len(needle)
    if n == 0 or len(hay) < n:
        return -1
    if n == 1:
        matches = np.nonzero(hay == needle[0])[0]
    else:
        windows = np.lib.stride_tricks.sliding_window_view(hay, n)
        matches = np.nonzero((windows == needle).all(axis=1))[0]
    return int(matches[-1]) if len(matches) else -1


class NgramProposer:
    """Greedy-draft proposer: longest-match n-gram lookup, self then cross."""

    def __init__(self, max_n: int = 3, min_n: int = 2,
                 prefix_cache: Optional[PrefixCache] = None):
        if max_n < 1:
            raise ValueError(f"max_n must be >= 1, got {max_n}")
        # 1-gram self-matches are mostly coincidence on anything but heavily
        # looping text, and every spurious draft turns a cheap decode step
        # into a wide verify step — so the self-lookup stops at min_n unless
        # the caller explicitly opts into 1-gram drafting.
        self.max_n = max_n
        self.min_n = max(1, min(min_n, max_n))
        self.prefix = prefix_cache
        self.proposals = 0
        self.proposed_tokens = 0
        self.accepted_tokens = 0
        # slot -> which source drafted last ("self" | "prefix"): a slot
        # streaming down a cached prompt re-hits the same source every
        # step, so that source is tried first and the other scan skipped
        # on a hit
        self._last_source: dict = {}

    # ------------------------------------------------------------------
    def _propose_self(self, context: np.ndarray,
                      max_draft: int) -> np.ndarray:
        for n in range(min(self.max_n, len(context) - 1),
                       self.min_n - 1, -1):
            tail = context[-n:]
            # search excludes the tail itself so a continuation always exists
            j = find_last_ngram(context[:-1], tail)
            if j >= 0:
                return context[j + n: j + n + max_draft].astype(np.int32)
        return np.empty(0, np.int32)

    def _propose_prefix(self, context: np.ndarray,
                        max_draft: int) -> np.ndarray:
        if self.prefix is not None:
            for n in range(min(self.max_n, len(context)),
                           self.min_n - 1, -1):
                d = self.prefix.draft(context[-n:], max_draft)
                if d is not None and len(d):
                    return d.astype(np.int32)
        return np.empty(0, np.int32)

    def propose(self, context: np.ndarray, max_draft: int,
                slot: Optional[int] = None) -> np.ndarray:
        """Up to ``max_draft`` draft tokens continuing ``context``."""
        context = np.asarray(context, np.int32).reshape(-1)
        if max_draft <= 0 or len(context) < 2:
            return np.empty(0, np.int32)
        sources = [("self", self._propose_self),
                   ("prefix", self._propose_prefix)]
        if slot is not None and self._last_source.get(slot) == "prefix":
            sources.reverse()
        for name, fn in sources:
            d = fn(context, max_draft)
            if len(d):
                if slot is not None:
                    self._last_source[slot] = name
                return d
        return np.empty(0, np.int32)

    # ------------------------------------------------------------------
    def record(self, proposed: int, accepted: int) -> None:
        """Account one verified proposal (engine calls this per slot/step)."""
        if proposed > 0:
            self.proposals += 1
            self.proposed_tokens += int(proposed)
            self.accepted_tokens += int(accepted)

    @property
    def accept_rate(self) -> float:
        if not self.proposed_tokens:
            return 0.0
        return self.accepted_tokens / self.proposed_tokens
