"""The serving engine's scheduling policies (counterpart of
`paddle_tpu/inference/scheduler.py`).

`ServingEngine` owns the mechanism of continuous batching (pages, prefill,
decode bursts, preemption); a policy makes the decisions and mutates
nothing: which pending request enters a free slot, which slot to evict when
the page pool runs dry, the (batch, token) bucket of a batched prefill, the
length of a decode burst, and the chunk and promotion budgets of chunked
prefill (which the engine serves) and the KV tiers (a hook kept for the
reference's surface; the port's engine has no tiers yet).

`FifoSchedulerPolicy` (the default, `FLAGS_scheduler_policy="fifo"`) is
strict head-of-line FIFO, youngest-admitted victim, next-pow2 batch buckets
with page-multiple token buckets, and {1, decode_burst} bursts.
`SloAwareSchedulerPolicy` admits the shortest pending prompt first while the
fast TTFT burn alert fires and evicts the slot with the most budget left. Its
default alert source is the reference's `observability/slo.py`, which is not
ported (ROADMAP Queue 1 item 7): it serves only with an injected
`firing_fn`, and without one it raises.
"""
from __future__ import annotations

import time as _time_mod
from typing import Dict, List, Optional, Sequence, Tuple

from ..framework import config as _cfg


class SchedulerPolicy:
    """Base policy: the decision hooks, defaults = the FIFO engine. Subclass
    and override; register with `register_policy`. Hooks must not mutate
    the engine."""

    name = "base"

    def select_admission(self, engine) -> Optional[int]:
        """Index into `engine._pending` of the next request to admit into a
        free slot, or None to end this admission round (strict head-of-line
        FIFO: the head waits until its context's pages fit). The engine
        re-checks the page fit before committing."""
        entry = engine._pending[0]
        return 0 if self._fits(engine, entry) else None

    @staticmethod
    def _fits(engine, entry) -> bool:
        """Admission takes only the context's pages (decode grows the
        allocation on demand), counted against the free list plus the
        prefix cache's evictable pages, which the engine reclaims at commit
        (`_avail_pages`); an engine without that count (a test double) is
        held to its free list."""
        _rid, ids, _max_new, prior = entry
        need = -(-(len(ids) + len(prior)) // engine.page_size)
        avail = engine._avail_pages() if hasattr(engine, "_avail_pages") \
            else len(engine._free_pages)
        return avail >= need

    def select_victim(self, engine, candidates: Sequence[int],
                      where: str = "page_stall") -> int:
        """Slot to evict (from the non-empty `candidates`). where=
        "page_stall": the pool ran dry growing this step's allocations
        ("decode_oom" is the reference's other cause; the port has no OOM
        recovery yet). Default: the youngest admitted, so the oldest always
        progress (vLLM's recompute policy)."""
        return max(candidates, key=lambda i: engine.slots[i].admit_seq)

    def prefill_bucket(self, engine, new: Sequence[Tuple[int, Sequence[int]]]
                       ) -> Tuple[int, int]:
        """(batch, tokens) of one batched prefill of `new` = [(slot,
        context_ids), ...]: the batch to the next power of two capped at
        max_batch, the tokens to the next page multiple of the longest."""
        nb = 1
        while nb < len(new):
            nb *= 2
        nb = min(nb, engine.max_batch)
        longest = max(len(ids) for _si, ids in new)
        bucket = -(-longest // engine.page_size) * engine.page_size
        return nb, bucket

    def burst_k(self, engine, active: Sequence[int],
                rem_of: Dict[int, int]) -> int:
        """Decode steps of this dispatch, bucketed to {1, decode_burst}: the
        full burst while any row has more than one token of budget left,
        one step when every row is on its last token (one program per
        distinct length, so a per-tail length would make one per budget)."""
        if engine.decode_burst > 1 and max(rem_of.values()) > 1:
            return engine.decode_burst
        return 1

    def prefill_chunk_budget(self, engine, prefilling: Sequence[int]) -> int:
        """Token width of a chunked-prefill continuation round (the engine
        page-aligns and clamps it). Default: the configured budget."""
        return engine.prefill_chunk

    def promotion_budget(self, engine, n_candidates: int) -> int:
        """Spilled prefix pages one admission may promote back from the KV
        tiers. Default: all of them."""
        return n_candidates


class FifoSchedulerPolicy(SchedulerPolicy):
    """The default: every base hook unchanged, registered as "fifo"."""

    name = "fifo"


class SloAwareSchedulerPolicy(SchedulerPolicy):
    """TTFT-burn-aware policy (`FLAGS_scheduler_policy="slo"`).

    Admission: while the fast TTFT burn alert fires, the shortest pending
    prompt that fits (shortest-first minimizes queue wait); otherwise FIFO.
    Victim: the slot with the most token budget left (ties: the youngest).
    Chunk and promotion budgets halve while the alert fires.

    `firing_fn()` returns the names of the firing alerts; its result is
    kept for `_TTL_S` seconds of `clock()`. The reference's default reads
    its SLO engine (`observability/slo.py`), not ported (ROADMAP Queue 1
    item 7), so `firing_fn` is required here."""

    name = "slo"
    _TTL_S = 0.5

    def __init__(self, firing_fn=None, clock=None):
        if firing_fn is None:
            raise NotImplementedError(
                "SloAwareSchedulerPolicy needs firing_fn: its default alert "
                "source, observability/slo.py, is not ported (ROADMAP Queue "
                "1 item 7)")
        self._firing_fn = firing_fn
        self._clock = clock or _time_mod.monotonic
        self._cached: Tuple[float, bool] = (-1e18, False)

    def _ttft_burning(self) -> bool:
        now = self._clock()
        t, val = self._cached
        if now - t < self._TTL_S:
            return val
        try:
            val = any(name.startswith("ttft") for name in self._firing_fn())
        except Exception:  # noqa: BLE001 - a broken alert source must not
            val = False    # stop admission (the reference's rule)
        self._cached = (now, val)
        return val

    def select_admission(self, engine) -> Optional[int]:
        if not self._ttft_burning():
            return super().select_admission(engine)
        best = best_len = None
        for idx, entry in enumerate(engine._pending):
            if not self._fits(engine, entry):
                continue
            _rid, ids, _mn, prior = entry
            ctx_len = len(ids) + len(prior)
            if best is None or ctx_len < best_len:
                best, best_len = idx, ctx_len
        return best

    def select_victim(self, engine, candidates: Sequence[int],
                      where: str = "page_stall") -> int:
        def _key(i):
            s = engine.slots[i]
            return (s.max_new_tokens - len(s.tokens), s.admit_seq)

        return max(candidates, key=_key)

    def prefill_chunk_budget(self, engine, prefilling: Sequence[int]) -> int:
        if self._ttft_burning():
            return max(engine.page_size, engine.prefill_chunk // 2)
        return engine.prefill_chunk

    def promotion_budget(self, engine, n_candidates: int) -> int:
        if self._ttft_burning():
            return max(1, n_candidates // 2)
        return n_candidates


_POLICIES: Dict[str, type] = {}


def register_policy(cls) -> type:
    """Register a SchedulerPolicy subclass under its `name`."""
    _POLICIES[cls.name] = cls
    return cls


register_policy(FifoSchedulerPolicy)
register_policy(SloAwareSchedulerPolicy)


def available_policies() -> List[str]:
    return sorted(_POLICIES)


def resolve_policy(policy=None) -> SchedulerPolicy:
    """The engine's constructor-time resolution: an instance passes through,
    a name looks up the registry, None reads FLAGS_scheduler_policy."""
    if isinstance(policy, SchedulerPolicy):
        return policy
    name = policy if policy is not None else \
        _cfg.get_flag("FLAGS_scheduler_policy", "fifo")
    cls = _POLICIES.get(name)
    if cls is None:
        raise ValueError(f"unknown scheduler policy {name!r}; available: "
                         f"{available_policies()}")
    return cls()
