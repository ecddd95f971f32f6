"""Continuous-batching decoder over a paged KV cache (counterpart of
`ServingEngine` in `paddle_tpu/inference/serving.py`).

    engine = ServingEngine(model, max_batch=8, max_seq_len=4096)
    rid = engine.add_request(prompt_ids, max_new_tokens=64)
    finished = engine.run()          # or: engine.step() in a loop

Requests queue in `add_request`. Each `step()` admits what fits (FIFO, the
prompt's pages only) and prefills the admitted prompts in one batched
dense-cache forward, whose K/V are then written into the pages; then it runs
one single-token decode step for every active slot through the paged
kernels. Pages are allocated as decode needs them; when the pool runs dry
the youngest slot is preempted, requeued at the front with its tokens so
far, and re-prefilled later (recompute preemption). Greedy token streams
equal the JAX engine's.

Ported: the parameters below, per-request sampling, eos and token-budget
finishes, on-demand pages and recompute preemption. Not ported: decode
bursts, async dispatch, speculative decoding, prefix cache, chunked prefill,
int8 KV, KV tiers and handoff, telemetry, recovery and tensor parallelism.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np
import torch

from ..framework.device import resolve_device
from ..kernels import paged_attention as _pa
from ..models.generation import sample_logits, sample_logits_per_row
from .scheduler import FifoSchedulerPolicy


@dataclass
class _Slot:
    request_id: int = -1
    tokens: list = field(default_factory=list)  # generated tokens
    context_len: int = 0  # tokens currently in the paged cache
    max_new_tokens: int = 0
    active: bool = False
    n_pages: int = 0      # pages currently allocated to this slot
    admit_seq: int = 0    # admission order (preemption picks the youngest)
    greedy: bool = True
    needs_first_sample: bool = False  # emit the prefill-time sample next
    first_token: int = -1


@dataclass
class FinishedRequest:
    request_id: int
    prompt_ids: np.ndarray
    output_ids: np.ndarray


class ServingEngine:
    def __init__(self, model, max_batch=4, max_seq_len=256, page_size=16,
                 decode_strategy="greedy_search", temperature=1.0, top_k=0,
                 top_p=1.0, eos_token_id=None, seed=0, device=None):
        if max_seq_len % page_size:
            raise ValueError("max_seq_len must be a multiple of page_size")
        max_pos = getattr(model.config, "max_position_embeddings", None)
        if max_pos is not None and max_seq_len > max_pos:
            raise ValueError(
                f"max_seq_len={max_seq_len} exceeds the model's "
                f"max_position_embeddings={max_pos}")
        self.device = resolve_device(device)
        param = next(model.parameters())
        if param.device != self.device:
            raise ValueError(f"the model lives on {param.device} but the "
                             f"engine serves on {self.device}")
        self.model = model
        self.cfg = cfg = model.config
        self.max_batch = max_batch
        self.max_seq_len = max_seq_len
        self.page_size = page_size
        self.pages_per_seq = max_seq_len // page_size
        self.decode_strategy = decode_strategy
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self.eos_token_id = eos_token_id
        n_pages = max_batch * self.pages_per_seq
        self._free_pages = list(range(n_pages))
        hd = cfg.hidden_size // cfg.num_attention_heads
        # pages in the model's dtype; the decode kernel accumulates in f32
        pools = [_pa.alloc_pages(n_pages, page_size,
                                 cfg.num_key_value_heads, hd, param.dtype,
                                 self.device)
                 for _ in range(cfg.num_hidden_layers)]
        self.k_pages = [k for k, _ in pools]
        self.v_pages = [v for _, v in pools]
        self.block_tables = np.zeros((max_batch, self.pages_per_seq),
                                     np.int32)
        self.slots = [_Slot() for _ in range(max_batch)]
        self.scheduler = FifoSchedulerPolicy()
        self._pending: List = []  # (rid, ids, max_new, prior_tokens)
        self._prompts: Dict[int, np.ndarray] = {}
        self._req_params: Dict[int, dict] = {}
        self._next_rid = 0
        self._admit_seq = 0
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(int(seed))
        # what ran: batched prefill calls, decode steps, preemptions
        self.prefills = 0
        self.decode_steps = 0
        self.preemptions = 0

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------
    def add_request(self, prompt_ids, max_new_tokens=32,
                    decode_strategy=None, temperature=None, top_k=None,
                    top_p=None, eos_token_id=None, on_token=None) -> int:
        """Queue a request; sampling parameters default to the engine's.
        on_token(rid, token) is called on the host as each token is
        committed (tokens already streamed are not re-streamed after a
        preemption)."""
        ids = np.asarray(prompt_ids).reshape(-1).astype(np.int64)
        if int(max_new_tokens) < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if len(ids) + int(max_new_tokens) > self.max_seq_len:
            raise ValueError(
                f"prompt ({len(ids)}) + max_new_tokens ({max_new_tokens}) "
                f"exceeds max_seq_len ({self.max_seq_len})")
        rid = self._next_rid
        self._next_rid += 1
        self._prompts[rid] = ids
        strategy = decode_strategy if decode_strategy is not None \
            else self.decode_strategy
        self._req_params[rid] = dict(
            greedy=strategy == "greedy_search",
            temperature=float(temperature if temperature is not None
                              else self.temperature),
            top_k=int(top_k if top_k is not None else self.top_k),
            top_p=float(top_p if top_p is not None else self.top_p),
            eos=eos_token_id if eos_token_id is not None
            else self.eos_token_id,
            on_token=on_token)
        self._pending.append((rid, ids, int(max_new_tokens), []))
        return rid

    def has_work(self) -> bool:
        return bool(self._pending) or any(s.active for s in self.slots)

    def _admit(self):
        """Admit every request that fits into a free slot, then prefill them
        all in one batched call."""
        new = []  # (slot_idx, context_ids)
        while self._pending:
            slot_idx = next(
                (i for i, s in enumerate(self.slots) if not s.active), None)
            if slot_idx is None:
                break
            pick = self.scheduler.select_admission(self)
            if pick is None:
                break
            rid, ids, max_new, prior = self._pending[pick]
            ctx = np.concatenate([ids, np.asarray(prior, np.int64)]) \
                if prior else ids
            need = -(-len(ctx) // self.page_size)
            if len(self._free_pages) < need:
                break
            self._pending.pop(pick)
            pages = [self._free_pages.pop() for _ in range(need)]
            self.block_tables[slot_idx, :need] = np.asarray(pages, np.int32)
            s = self.slots[slot_idx]
            s.request_id, s.tokens = rid, list(prior)
            s.max_new_tokens = max_new
            s.n_pages = need
            s.greedy = self._req_params[rid]["greedy"]
            s.admit_seq = self._admit_seq
            self._admit_seq += 1
            s.context_len = len(ctx)
            s.needs_first_sample = True
            s.active = True
            new.append((slot_idx, ctx))
        if new:
            self._prefill_batch(new)

    # ------------------------------------------------------------------
    # pages
    # ------------------------------------------------------------------
    def _release_slot(self, slot_idx):
        s = self.slots[slot_idx]
        self._free_pages.extend(
            self.block_tables[slot_idx, :s.n_pages].tolist())
        s.n_pages = 0
        s.active = False

    def _ensure_pages(self, slot_idx, steps) -> bool:
        """Grow the slot's pages to cover `steps` more tokens; False when
        the pool is empty (the caller preempts)."""
        s = self.slots[slot_idx]
        need = -(-(s.context_len + steps) // self.page_size)
        while s.n_pages < need:
            if not self._free_pages:
                return False
            self.block_tables[slot_idx, s.n_pages] = self._free_pages.pop()
            s.n_pages += 1
        return True

    def _preempt(self, slot_idx):
        """Free the slot's pages and requeue its request at the front of the
        queue with the tokens generated so far; it re-prefills later."""
        s = self.slots[slot_idx]
        self._release_slot(slot_idx)
        self._pending.insert(0, (s.request_id, self._prompts[s.request_id],
                                 s.max_new_tokens, list(s.tokens)))
        self.preemptions += 1

    # ------------------------------------------------------------------
    # prefill and decode
    # ------------------------------------------------------------------
    def _sample(self, logits, all_greedy, params):
        if all_greedy:
            return sample_logits(logits, self._gen, "greedy_search")[0]
        greedy, temp, tk, tp = (torch.from_numpy(a).to(self.device)
                                for a in params)
        return sample_logits_per_row(logits, self._gen, greedy, temp, tk,
                                     tp)[0]

    def _row_params(self, rids):
        """Per-row (greedy, temperature, top_k, top_p) arrays; None marks a
        row with no request (greedy defaults)."""
        d = dict(greedy=True, temperature=1.0, top_k=0, top_p=1.0)
        rps = [self._req_params.get(r, d) if r is not None else d
               for r in rids]
        return (np.asarray([rp["greedy"] for rp in rps], bool),
                np.asarray([rp["temperature"] for rp in rps], np.float32),
                np.asarray([rp["top_k"] for rp in rps], np.int64),
                np.asarray([rp["top_p"] for rp in rps], np.float32))

    @torch.no_grad()
    def _prefill_batch(self, new):
        """One dense-cache forward over every admitted prompt (padded to the
        scheduler's bucket), the first token of each sampled from its last
        position, then the prompts' K/V written into their pages."""
        n = len(new)
        nb, bucket = self.scheduler.prefill_bucket(self, new)
        nb = min(max(nb, n), self.max_batch)
        longest = max(len(ids) for _, ids in new)
        bucket = max(-(-bucket // self.page_size) * self.page_size,
                     -(-longest // self.page_size) * self.page_size)
        padded = np.zeros((nb, bucket), np.int64)
        true_lens = np.ones((nb,), np.int64)
        for row, (_si, ids) in enumerate(new):
            padded[row, :len(ids)] = ids
            true_lens[row] = len(ids)
        rids = [self.slots[si].request_id for si, _ in new]
        params = self._row_params(rids + [None] * (nb - n))
        all_greedy = all(self.slots[si].greedy for si, _ in new)
        dev = self.device
        caches = self.model.init_kv_caches(nb, bucket)
        logits, caches = self.model.forward_cached(
            torch.from_numpy(padded).to(dev), caches, 0)
        # causal: position true_len - 1 never saw the padding
        last = logits[torch.arange(nb, device=dev),
                      torch.from_numpy(true_lens - 1).to(dev)]
        first = self._sample(last, all_greedy, params)
        tables = torch.from_numpy(
            self.block_tables[[si for si, _ in new]]).to(dev)
        lens = torch.from_numpy(true_lens[:n])  # host: masks without a sync
        for li, (kc, vc) in enumerate(caches):
            _pa.prefill_paged_kv_cache(self.k_pages[li], self.v_pages[li],
                                       kc[:n], vc[:n], tables, lens)
        del caches
        first = first.cpu().numpy()
        for row, (si, _) in enumerate(new):
            self.slots[si].first_token = int(first[row])
        self.prefills += 1

    @torch.no_grad()
    def _decode(self, tokens, active):
        """One single-token decode step over all max_batch rows (rows not
        in `active` write and attend nothing). Returns the next token of
        every row (host numpy)."""
        dev = self.device
        act = np.zeros((self.max_batch,), bool)
        act[active] = True
        lens = np.asarray([s.context_len if act[i] else 0
                           for i, s in enumerate(self.slots)], np.int32)
        rids = [s.request_id if act[i] else None
                for i, s in enumerate(self.slots)]
        all_greedy = all(self.slots[i].greedy for i in active)
        logits, _ = self.model.forward_paged(
            torch.from_numpy(tokens).to(dev)[:, None],
            list(zip(self.k_pages, self.v_pages)),
            torch.from_numpy(self.block_tables).to(dev),
            torch.from_numpy(lens).to(dev),
            active=torch.from_numpy(act))  # host mask: no device sync
        nxt = self._sample(logits[:, 0], all_greedy, self._row_params(rids))
        self.decode_steps += 1
        return nxt.cpu().numpy()

    def _req_eos(self, rid):
        rp = self._req_params.get(rid)
        return rp["eos"] if rp is not None else self.eos_token_id

    def _commit(self, slot_idx, token) -> bool:
        """Append a token to the slot's stream; True if the request is now
        finished (eos or budget)."""
        s = self.slots[slot_idx]
        s.tokens.append(int(token))
        rp = self._req_params.get(s.request_id)
        if rp is not None and rp["on_token"] is not None:
            rp["on_token"](s.request_id, int(token))
        eos = self._req_eos(s.request_id)
        return len(s.tokens) >= s.max_new_tokens or (
            eos is not None and s.tokens[-1] == eos)

    def step(self) -> List[FinishedRequest]:
        """Admit and prefill what fits, then one decode step for every
        active slot. Returns the requests that finished in this step."""
        self._admit()
        active = [i for i, s in enumerate(self.slots) if s.active]
        if not active:
            return []
        # a slot's first step emits its prefill-time sample
        tokens = np.zeros((self.max_batch,), np.int64)
        first_done = []
        for i in active:
            s = self.slots[i]
            if s.needs_first_sample:
                s.needs_first_sample = False
                if self._commit(i, s.first_token):
                    first_done.append(i)
            tokens[i] = s.tokens[-1]
        finished = [self._finish(i) for i in first_done]
        active = [i for i in active if i not in first_done]
        # on-demand page for the position this step writes; an empty pool
        # preempts the youngest stalled slot and retries
        while active:
            stalled = [i for i in active if not self._ensure_pages(i, 1)]
            if not stalled:
                break
            victim = self.scheduler.select_victim(self, stalled)
            self._preempt(victim)
            active = [i for i in active if i != victim]
        if not active:
            if finished:
                self._admit()
            return finished
        nxt = self._decode(tokens, active)
        for i in active:
            self.slots[i].context_len += 1  # the fed token is now cached
            if self._commit(i, nxt[i]):
                finished.append(self._finish(i))
        if finished:
            self._admit()
        return finished

    def _finish(self, slot_idx) -> FinishedRequest:
        s = self.slots[slot_idx]
        self._release_slot(slot_idx)
        self._req_params.pop(s.request_id, None)
        prompt = self._prompts.pop(s.request_id)
        return FinishedRequest(request_id=s.request_id, prompt_ids=prompt,
                               output_ids=np.asarray(s.tokens, np.int64))

    def run(self, max_steps=10_000) -> List[FinishedRequest]:
        out = []
        steps = 0
        while self.has_work() and steps < max_steps:
            out.extend(self.step())
            steps += 1
        return out
