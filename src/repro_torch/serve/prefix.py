"""Prefix cache: hash-chained page sharing for common prompt heads.

Each *full* page of a prompt is keyed by the hash of every token up to and
including that page (a hash chain, so a key identifies the entire prefix and
not just the page's own tokens).  Matching walks the chain from page 0 and
shares physical pages for as long as keys hit — requests with a common
prompt head then reference the same pages, because causal attention makes a
position's K/V depend only on the tokens at or before it.

Only full pages are ever shared, and decode writes land at positions at or
past the prompt length, so shared pages are immutable — no copy-on-write is
needed.

Whole-prompt entries additionally store the prefill's last-token logits and
a snapshot of the recurrent (mamba) state, enabling a skip-prefill fast path
when an identical, page-aligned prompt is admitted again.  Reused logits are
bit-identical to a cold prefill by construction: they *are* the stored output
of one.

The cache holds one pool reference per registered page; ``release_lru``
drops the oldest chains when the pool runs dry, and ``clear`` drops
everything (after which a drained pool must report zero pages in use — the
leak invariant ``tests/test_serve.py`` checks).

Eviction-order invariant (DESIGN.md §13): the registered chain keys always
form a *prefix-closed* set — every key's parent (the chain one page shorter)
is registered too.  ``match()`` walks from page 0 and breaks at the first
missing key, so dropping a mid-chain page would make every descendant
unreachable while its entry kept pinning a pool reference (a strand).
``release_lru`` therefore evicts suffix-first: only chain *leaves* (keys with
no registered children) are ever dropped, oldest leaf first, which unwinds
the LRU chain from its tail without ever stranding a descendant.
"""

from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serve.paging import PagePool


def _chain_key(tokens: np.ndarray) -> str:
    return hashlib.sha1(np.ascontiguousarray(tokens, np.int32).tobytes()).hexdigest()


@dataclasses.dataclass
class FullPromptEntry:
    page_ids: Tuple[int, ...]
    last_logits: np.ndarray
    state: Any  # snapshot_state tree, or None for stateless archs
    tokens: Optional[np.ndarray] = None  # the prompt itself (draft source)


class PrefixCache:
    def __init__(self, page_size: int):
        self.page_size = page_size
        # chain-hash -> physical page id, in LRU order (oldest first)
        self._pages: "OrderedDict[str, int]" = OrderedDict()
        # chain linkage: key -> parent key (None for page-0 keys) and the
        # number of registered children.  Eviction only ever drops keys with
        # zero children (chain leaves), so the key set stays prefix-closed
        # and no registered page can become unreachable via ``match``.
        self._parent: Dict[str, Optional[str]] = {}
        self._nchildren: Dict[str, int] = {}
        self._full: "OrderedDict[str, FullPromptEntry]" = OrderedDict()
        # counters are maintained by the scheduler on *successful* admission
        # only, so a request blocked on pages and retried every step does not
        # inflate them
        self.hits = 0
        self.pages_shared = 0
        self.prefills_skipped = 0
        # key of the entry that served the last speculative draft (MRU
        # fast path for ``draft``)
        self._draft_hit: Optional[str] = None

    # ------------------------------------------------------------------
    def match(self, prompt: np.ndarray, pool: PagePool) -> List[int]:
        """Longest chain of already-cached full pages for ``prompt``.  Takes
        one reference per matched page on behalf of the caller."""
        ps = self.page_size
        matched: List[int] = []
        for j in range(len(prompt) // ps):
            key = _chain_key(prompt[: (j + 1) * ps])
            pid = self._pages.get(key)
            if pid is None:
                break
            self._pages.move_to_end(key)
            matched.append(pid)
        if matched:
            pool.share(matched)
        return matched

    def peek(self, prompt: np.ndarray) -> int:
        """Number of leading full pages of ``prompt`` the cache could share,
        with no side effects: no references taken and no LRU bumps.  Routers
        probe every replica with this — only the replica that actually
        receives the request should perturb its cache state."""
        ps = self.page_size
        n = 0
        for j in range(len(prompt) // ps):
            if _chain_key(prompt[: (j + 1) * ps]) not in self._pages:
                break
            n += 1
        return n

    def register(
        self, prompt: np.ndarray, page_ids: Sequence[int], pool: PagePool
    ) -> None:
        """Publish ``prompt``'s full pages (already written) for future
        sharing.  The cache takes its own reference on each new page."""
        ps = self.page_size
        prev: Optional[str] = None
        for j in range(len(prompt) // ps):
            key = _chain_key(prompt[: (j + 1) * ps])
            if key in self._pages:
                self._pages.move_to_end(key)
            else:
                pool.share([page_ids[j]])
                self._pages[key] = page_ids[j]
                # j > 0 keys always have a registered parent: this loop just
                # inserted (or bumped) the one-page-shorter chain
                self._parent[key] = prev
                self._nchildren[key] = 0
                if prev is not None:
                    self._nchildren[prev] += 1
            prev = key

    # ------------------------------------------------------------------
    def match_full(
        self, prompt: np.ndarray, pool: PagePool
    ) -> Optional[FullPromptEntry]:
        """Skip-prefill fast path: exact whole-prompt entry (page-aligned
        prompts only).  Shares the entry's pages on behalf of the caller."""
        if len(prompt) % self.page_size:
            return None
        entry = self._full.get(_chain_key(prompt))
        if entry is None:
            return None
        self._full.move_to_end(_chain_key(prompt))
        pool.share(entry.page_ids)
        return entry

    def register_full(
        self,
        prompt: np.ndarray,
        page_ids: Sequence[int],
        last_logits: np.ndarray,
        state: Any,
        pool: PagePool,
    ) -> None:
        if len(prompt) % self.page_size:
            return  # only page-aligned prompts are exactly reusable
        key = _chain_key(prompt)
        if key in self._full:
            return
        pool.share(page_ids)
        self._full[key] = FullPromptEntry(
            tuple(page_ids),
            np.asarray(last_logits),
            state,
            np.asarray(prompt, np.int32).copy(),
        )

    # ------------------------------------------------------------------
    def draft(self, ngram: np.ndarray, max_draft: int) -> Optional[np.ndarray]:
        """Cross-request draft source for speculative decode: the tokens
        that followed the last occurrence of ``ngram`` in the most recently
        used stored prompt containing it (see ``repro_torch.serve.speculate``)."""
        from repro_torch.serve.speculate import find_last_ngram

        ngram = np.asarray(ngram, np.int32).reshape(-1)
        if max_draft <= 0 or len(ngram) == 0:
            return None

        def scan(entry: FullPromptEntry) -> Optional[np.ndarray]:
            if entry.tokens is None:
                return None
            j = find_last_ngram(entry.tokens, ngram)
            if j < 0 or j + len(ngram) >= len(entry.tokens):
                return None
            start = j + len(ngram)
            return entry.tokens[start: start + max_draft].copy()

        # a drafting slot streams down one source prompt, re-matching it
        # every step — try the entry that produced the previous draft before
        # scanning the whole registry.  Every served draft MRU-bumps its
        # source entry: an actively-drafting source that sat at the LRU end
        # would otherwise be evicted mid-stream under pool pressure,
        # silently killing the speculative accept rate.
        hit = self._draft_hit
        if hit is not None and hit in self._full:
            d = scan(self._full[hit])
            if d is not None:
                self._full.move_to_end(hit)
                return d
        for key in reversed(list(self._full)):
            if key == hit:
                continue
            d = scan(self._full[key])
            if d is not None:
                self._draft_hit = key
                self._full.move_to_end(key)
                return d
        return None

    # ------------------------------------------------------------------
    def _drop_key(self, key: str, pool: PagePool) -> None:
        pid = self._pages.pop(key)
        parent = self._parent.pop(key, None)
        self._nchildren.pop(key, None)
        if parent is not None and parent in self._nchildren:
            self._nchildren[parent] -= 1
        pool.free([pid])

    def release_lru(self, pool: PagePool, min_free: int) -> int:
        """Drop oldest entries until ``pool.free_pages >= min_free`` (or the
        cache is empty).  Returns the number of references released.

        Chain pages are evicted suffix-first: only *leaves* (keys with no
        registered children) are candidates, oldest leaf first.  Evicting a
        mid-chain page would strand every descendant — ``match`` breaks at
        the first missing key, so stranded entries could never be shared
        again yet would keep pinning pool references (see module docstring).
        """
        released = 0
        while pool.free_pages < min_free and (self._pages or self._full):
            if self._full:
                _, entry = self._full.popitem(last=False)
                pool.free(entry.page_ids)
                released += len(entry.page_ids)
            else:
                key = next(k for k in self._pages if self._nchildren.get(k, 0) == 0)
                self._drop_key(key, pool)
                released += 1
        return released

    def clear(self, pool: PagePool) -> None:
        for pid in self._pages.values():
            pool.free([pid])
        self._pages.clear()
        self._parent.clear()
        self._nchildren.clear()
        for entry in self._full.values():
            pool.free(entry.page_ids)
        self._full.clear()
