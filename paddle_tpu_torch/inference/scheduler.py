"""The serving engine's default scheduling policy (counterpart of the FIFO
policy in `paddle_tpu/inference/scheduler.py`).

`ServingEngine` owns the mechanism of continuous batching (pages, prefill,
decode, preemption); the policy makes three decisions and mutates nothing:
which pending request enters a free slot, which slot to evict when the page
pool runs dry, and the (batch, token) bucket of a batched prefill. The SLO
policy and the burst, chunk and promotion hooks of the JAX package are not
ported.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple


class FifoSchedulerPolicy:
    def select_admission(self, engine) -> Optional[int]:
        """Index into `engine._pending` of the next request to admit, or
        None to end this admission round: strict head-of-line FIFO, the
        head waits until its context's pages fit."""
        entry = engine._pending[0]
        return 0 if self._fits(engine, entry) else None

    @staticmethod
    def _fits(engine, entry) -> bool:
        """Admission takes only the context's pages; decode grows the
        allocation on demand."""
        _rid, ids, _max_new, prior = entry
        need = -(-(len(ids) + len(prior)) // engine.page_size)
        return len(engine._free_pages) >= need

    def select_victim(self, engine, candidates: Sequence[int]) -> int:
        """Slot to evict (from the non-empty `candidates`) when the pool
        runs dry: the youngest admitted, so the oldest always progress
        (vLLM's recompute policy)."""
        return max(candidates, key=lambda i: engine.slots[i].admit_seq)

    def prefill_bucket(self, engine, new) -> Tuple[int, int]:
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
