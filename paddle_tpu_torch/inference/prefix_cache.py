"""Content-addressed prefix cache over the serving engine's KV pages
(counterpart of `paddle_tpu/inference/prefix_cache.py`, without its spill
tiers).

A trie keyed on page-aligned token chunks maps a token prefix to the pages
that hold its K/V, so admission can match the longest cached prefix, take
references on its pages and prefill only the uncached suffix. Only FULL
pages are shared: a partially filled tail page never enters the trie, so a
shared page is never written again (decode and the prefill continuation
always write past the shared region, into pages the row owns alone).

Refcounts: the trie holds ONE reference on every page it caches and each
slot row one per page of its block-table row. A page is on the free list
exactly when its count is 0. A page whose only reference is the trie's
(count 1) is resident but reclaimable: `evict(need)` drops least-recently
touched leaves back to the free list.

Node keys are the literal token tuples (exact, collision-free).
`prefix_hash` is the router's key for "the prefix" (its `cache_affinity`
policy); `_Node.digest` is the chain digest of the node's token path, the
key the reference's spill tiers file a page under. The tiers
(`TieredStore`, `attach_tiers`, `spilled_suffix`) are not ported.
"""
from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Tuple

import numpy as np


def prefix_hash(ids, page_size: int, max_pages: int = 4) -> Optional[int]:
    """Stable 64-bit hash of a prompt's page-aligned prefix (at most
    `max_pages` chunks): the router's cache_affinity key. None when the
    prompt is shorter than one full page (nothing shareable)."""
    ids = np.asarray(ids, np.int64).reshape(-1)
    n = (len(ids) // page_size) * page_size
    n = min(n, max_pages * page_size)
    if n <= 0:
        return None
    dig = hashlib.blake2b(ids[:n].tobytes(), digest_size=8).digest()
    return int.from_bytes(dig, "big")


# chain-digest seed of the trie root: a node's digest is blake2b(parent
# digest + its token chunk), a pure function of its token path
_ROOT_DIGEST = b"pt-kv-root"


def _chain_digest(parent_digest: bytes, chunk: tuple) -> bytes:
    return hashlib.blake2b(
        parent_digest + np.asarray(chunk, np.int64).tobytes(),
        digest_size=16).digest()


class _Node:
    __slots__ = ("chunk", "page", "children", "parent", "tick", "digest")

    def __init__(self, chunk: tuple, page: int, parent, digest: bytes = b""):
        self.chunk = chunk
        self.page = page
        self.children: Dict[tuple, "_Node"] = {}
        self.parent = parent
        self.tick = 0
        self.digest = digest


class PrefixCache:
    """The trie. It changes the engine's `page_refs` / `free_pages` (lists
    the engine owns, mutated in place) only by its incref at `insert` and
    the decref of `evict`; every reference it holds is a page of
    `pages()`."""

    def __init__(self, page_size: int, page_refs: List[int],
                 free_pages: List[int]):
        self.page_size = page_size
        self._refs = page_refs
        self._free = free_pages
        self._root: Dict[tuple, _Node] = {}
        self._by_page: Dict[int, _Node] = {}
        self._clock = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._by_page)

    def pages(self) -> List[int]:
        """Every page the trie holds a reference on."""
        return list(self._by_page)

    def owns(self, page: int) -> bool:
        return page in self._by_page

    def evictable(self) -> int:
        """Pages whose only reference is the trie's: headroom admission may
        count on beyond the free list (a parent goes after its children,
        but every such page can be reclaimed in turn)."""
        return sum(1 for p in self._by_page if self._refs[p] == 1)

    def _chunks(self, ctx, n_pages: int):
        ps = self.page_size
        for j in range(n_pages):
            yield tuple(int(t) for t in ctx[j * ps:(j + 1) * ps])

    def match(self, ctx) -> Tuple[List[int], int]:
        """Longest cached page-aligned prefix of `ctx`: (page ids, tokens
        covered), at most len(ctx) - 1 tokens, so that at least one token
        is recomputed and the first sample has logits to come from. Touches
        the matched path's ticks; takes no references (the engine takes one
        per page it puts in a row)."""
        max_pages = (len(ctx) - 1) // self.page_size
        pages: List[int] = []
        self._clock += 1
        level = self._root
        for chunk in self._chunks(ctx, max_pages):
            node = level.get(chunk)
            if node is None:
                break
            node.tick = self._clock
            pages.append(node.page)
            level = node.children
        return pages, len(pages) * self.page_size

    def insert(self, ctx, page_row) -> int:
        """Cache the FULL pages of a freshly prefilled context: page_row[j]
        holds ctx[j * page_size:(j + 1) * page_size]. Existing nodes stay
        (the first writer wins; a duplicate page stays its row's own); each
        new node takes the trie's reference on its page. Returns the pages
        newly cached."""
        n_pages = len(ctx) // self.page_size
        self._clock += 1
        level = self._root
        parent = None
        added = 0
        dig = _ROOT_DIGEST
        for j, chunk in enumerate(self._chunks(ctx, n_pages)):
            dig = _chain_digest(dig, chunk)
            node = level.get(chunk)
            if node is None:
                page = int(page_row[j])
                if page in self._by_page:
                    # the page caches another path (not reached from the
                    # engine): stop here
                    break
                node = _Node(chunk, page, parent, digest=dig)
                level[chunk] = node
                self._by_page[page] = node
                self._refs[page] += 1
                added += 1
            node.tick = self._clock
            parent = node
            level = node.children
        return added

    def evict(self, need: int) -> int:
        """Free at least `need` pages by dropping least-recently touched
        leaves whose page has no slot reference (count 1). Returns the pages
        freed (fewer than `need` when the rest is held by live rows)."""
        freed = 0
        while freed < need:
            victim = None
            for node in self._by_page.values():
                if node.children or self._refs[node.page] != 1:
                    continue
                if victim is None or node.tick < victim.tick:
                    victim = node
            if victim is None:
                break
            self._drop(victim)
            freed += 1
            self.evictions += 1
        return freed

    def _drop(self, node: _Node):
        level = node.parent.children if node.parent is not None \
            else self._root
        level.pop(node.chunk, None)
        self._by_page.pop(node.page, None)
        self._refs[node.page] -= 1
        if self._refs[node.page] == 0:
            self._free.append(node.page)

    def clear(self) -> int:
        """Drop every node WITHOUT touching the refcounts or the free list
        (for a caller that rebuilds the pools and resets the accounting
        itself). Returns the nodes dropped."""
        n = len(self._by_page)
        self._root = {}
        self._by_page = {}
        return n
