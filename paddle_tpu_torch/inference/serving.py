"""Continuous-batching decoder over a paged KV cache (counterpart of
`ServingEngine` in `paddle_tpu/inference/serving.py`).

    engine = ServingEngine(model, max_batch=8, max_seq_len=4096,
                           decode_burst=8, async_depth=2)
    engine.warmup()                  # optional: capture before traffic
    rid = engine.add_request(prompt_ids, max_new_tokens=64)
    finished = engine.run()          # or: engine.step() in a loop

Requests queue in `add_request`. Each `step()` admits what fits (the
scheduler policy's order, the prompt's pages only) and prefills the
admitted prompts in one batched dense-cache forward, whose K/V are then
written into the pages; then it runs one decode dispatch for every active
slot through the paged kernels. Pages are allocated as decode needs them;
when the pool runs dry the policy's victim is preempted, requeued at the
front with its tokens so far, and re-prefilled later (recompute
preemption). Greedy token streams equal the JAX engine's.

Multi-step decode (`decode_burst=K`): a dispatch runs K decode steps with
sampling on the device, the per-row finish rules (`burst_rules`: budget and
eos) deactivating rows as they finish, and the host replays the K steps'
tokens afterwards (callbacks in order, `abort` from a callback honoured at
once). A dispatch of k steps is one decode program, keyed (all_greedy, k),
k in {1, K} (`SchedulerPolicy.burst_k`). It reads and writes one set of
static device buffers (the launch state, the block table, the k steps'
tokens and emit flags) and ends by writing its final carry (last token,
lens, active, budget) back into them. On CUDA with K > 1 each program is
captured once as a `torch.cuda.CUDAGraph` (the counterpart of the
reference's compiled `lax.scan`) after one eager call with every row
inactive on a side stream, and a dispatch replays it; a capture that fails
raises. With K = 1, or on the CPU, the same program runs eagerly. The
engine's generator is registered with each sampling graph, so a replay
draws fresh numbers. Inactive rows write the pools' scratch page (one past
the pages the free list hands out) and attend nothing, so a dispatch reads
nothing back to the host until its tokens.

`async_depth=N` (with K > 1): in pure decode (no queue, no pending first
tokens) the host keeps up to N bursts in flight, each replayed off the
previous one's carry in the buffers; every burst copies its tokens to its
own pinned host buffer and records an event, and the host replays the
oldest while newer ones run. Pages are reserved for every in-flight burst
plus the next; a finish or abort drains the pipeline before any page can
be reused. All bursts run on one stream (the kernels' tickets forbid
overlapping launches).

`kv_cache_quant="int8"` keeps the pages in int8 with one f32 scale per (kv
head, page, slot). A weight-only quantized model (`nn.quant.
quantize_for_inference`) serves as it is.

Not ported (the constructor accepts their defaults and raises on anything
else): tensor parallelism (`mesh`), speculative decoding, the prefix cache,
chunked prefill, the KV tiers; nor OOM recovery, handoff or telemetry.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np
import torch

from ..framework.device import resolve_device
from ..kernels import autotune as _at
from ..kernels import paged_attention as _pa
from ..models.generation import sample_logits, sample_logits_per_row
from . import scheduler as _sched


def burst_rules(tok, lens, act, rem, nxt, eos):
    """One decode step's per-row rules (the reference's burst scan body):
    the rows active in this step emitted `nxt`; each advances its length
    and spends one token of budget, and stays active while it has budget
    left and did not emit its eos. Returns (tok, lens, act, rem,
    emitted)."""
    emitted = act
    lens = lens + act.to(lens.dtype)
    rem = rem - act.to(rem.dtype)
    act = act & (rem > 0) & (nxt != eos)
    tok = torch.where(emitted, nxt, tok)
    return tok, lens, act, rem, emitted


# constructor arguments of the reference whose features are not ported:
# (name, is the value the feature's off state, ROADMAP item)
_NOT_PORTED = (
    ("mesh", lambda v: v is None,
     "tensor-parallel serving, ROADMAP Queue 1 item 4"),
    ("spec_decode", lambda v: v is None or int(v) < 2,
     "speculative decode, ROADMAP Queue 1 item 2"),
    ("spec_draft_layers", lambda v: v is None,
     "speculative decode, ROADMAP Queue 1 item 2"),
    ("draft_model", lambda v: v is None,
     "speculative decode, ROADMAP Queue 1 item 2"),
    ("prefix_cache", lambda v: v is None or not int(v),
     "the prefix cache, ROADMAP Queue 1 item 2"),
    ("prefill_chunk", lambda v: v is None or int(v) <= 0,
     "chunked prefill, ROADMAP Queue 1 item 2"),
    ("kv_host_cache_mb", lambda v: v is None or int(v) <= 0,
     "KV tiers, ROADMAP Queue 1 item 2"),
    ("kv_disk_cache_dir", lambda v: not v,
     "KV tiers, ROADMAP Queue 1 item 2"),
)


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


class _LaunchBuffers:
    """The decode programs' static device tensors. The launch state (last
    token, lens, active, budget, eos, sampling parameters) and the block
    table are written from the host before a dispatch; a program reads
    them, writes its k steps' tokens and emit flags into `toks[:k]` /
    `emits[:k]`, and its final carry back into tok / lens / act / rem.
    Every program uses these same tensors, so a captured graph replays on
    whatever they hold."""

    def __init__(self, batch, pages_per_seq, k_max, dev):
        def new(fill, dtype, *shape):
            return torch.full(shape or (batch,), fill, dtype=dtype,
                              device=dev)

        self.tok = new(0, torch.int64)
        self.lens = new(0, torch.int32)
        self.act = new(False, torch.bool)
        self.rem = new(0, torch.int32)
        self.eos = new(-1, torch.int64)
        self.greedy = new(True, torch.bool)
        self.temp = new(1.0, torch.float32)
        self.top_k = new(0, torch.int64)
        self.top_p = new(1.0, torch.float32)
        self.tables = new(0, torch.int32, batch, pages_per_seq)
        self.toks = new(0, torch.int64, k_max, batch)
        self.emits = new(False, torch.bool, k_max, batch)

    def stage(self, st, tokens):
        """Write a launch state (`ServingEngine._decode_launch_state`)."""
        for dst, src in ((self.tok, tokens), (self.lens, st["lens"]),
                         (self.act, st["act_mask"]), (self.rem, st["rem"]),
                         (self.eos, st["eos"]), (self.greedy, st["greedy"]),
                         (self.temp, st["temp"]), (self.top_k, st["tk"]),
                         (self.top_p, st["tp"])):
            dst.copy_(torch.from_numpy(src), non_blocking=True)

    def idle(self):
        """Every row inactive: a program then writes only the scratch
        page."""
        for t, v in ((self.tok, 0), (self.lens, 0), (self.act, False),
                     (self.rem, 0), (self.eos, -1), (self.greedy, True),
                     (self.temp, 1.0), (self.top_k, 0), (self.top_p, 1.0),
                     (self.tables, 0)):
            t.fill_(v)


class _HostSlot:
    """Where one dispatch's tokens and emit flags land on the host: pinned
    on CUDA, with the event recorded after the copies."""

    def __init__(self, batch, k_max, dev):
        cuda = dev.type == "cuda"
        self.toks = torch.zeros(k_max, batch, dtype=torch.int64,
                                pin_memory=cuda)
        self.emits = torch.zeros(k_max, batch, dtype=torch.bool,
                                 pin_memory=cuda)
        self.event = torch.cuda.Event() if cuda else None


class ServingEngine:
    def __init__(self, model, max_batch=4, max_seq_len=256, page_size=16,
                 decode_strategy="greedy_search", temperature=1.0, top_k=0,
                 top_p=1.0, eos_token_id=None, seed=0, mesh=None,
                 decode_burst=1, kv_cache_quant=None, async_depth=0,
                 spec_decode=None, spec_draft_layers=None, draft_model=None,
                 scheduler=None, prefix_cache=None, prefill_chunk=None,
                 kv_host_cache_mb=None, kv_disk_cache_dir=None,
                 device=None):
        given = dict(mesh=mesh, spec_decode=spec_decode,
                     spec_draft_layers=spec_draft_layers,
                     draft_model=draft_model, prefix_cache=prefix_cache,
                     prefill_chunk=prefill_chunk,
                     kv_host_cache_mb=kv_host_cache_mb,
                     kv_disk_cache_dir=kv_disk_cache_dir)
        for name, off, item in _NOT_PORTED:
            if not off(given[name]):
                raise NotImplementedError(
                    f"ServingEngine({name}={given[name]!r}): {item} is not "
                    f"ported")
        if kv_cache_quant not in (None, "int8"):
            raise ValueError("kv_cache_quant must be None or 'int8'")
        if max_seq_len % page_size:
            raise ValueError("max_seq_len must be a multiple of page_size")
        max_pos = getattr(model.config, "max_position_embeddings", None)
        if max_pos is not None and max_seq_len > max_pos:
            raise ValueError(
                f"max_seq_len={max_seq_len} exceeds the model's "
                f"max_position_embeddings={max_pos}")
        self.device = dev = resolve_device(device)
        param = next(model.parameters())
        if param.device != dev:
            raise ValueError(f"the model lives on {param.device} but the "
                             f"engine serves on {dev}")
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
        self.decode_burst = max(1, int(decode_burst))
        self.async_depth = max(0, int(async_depth))
        n_pages = max_batch * self.pages_per_seq
        self._free_pages = list(range(n_pages))
        # one more page in each pool: the scratch page inactive rows write
        self._scratch = n_pages
        hd = cfg.hidden_size // cfg.num_attention_heads
        kvh, L = cfg.num_key_value_heads, cfg.num_hidden_layers
        # pages in the model's dtype, or int8 plus per-slot f32 scales; the
        # decode kernels accumulate in f32
        self.kv_cache_quant = kv_cache_quant
        kv_dtype = torch.int8 if kv_cache_quant else param.dtype
        pools = [_pa.alloc_pages(n_pages + 1, page_size, kvh, hd, kv_dtype,
                                 dev) for _ in range(L)]
        self.k_pages = [k for k, _ in pools]
        self.v_pages = [v for _, v in pools]
        self.k_scales = self.v_scales = None
        if kv_cache_quant:
            scales = [_pa.alloc_page_scales(n_pages + 1, page_size, kvh, dev)
                      for _ in range(L)]
            self.k_scales = [k for k, _ in scales]
            self.v_scales = [v for _, v in scales]
        self._caches = list(zip(
            self.k_pages, self.v_pages,
            *((self.k_scales, self.v_scales) if kv_cache_quant else ())))
        self.block_tables = np.zeros((max_batch, self.pages_per_seq),
                                     np.int32)
        self.slots = [_Slot() for _ in range(max_batch)]
        self.scheduler = _sched.resolve_policy(scheduler)
        self._pending: List = []  # (rid, ids, max_new, prior_tokens)
        self._prompts: Dict[int, np.ndarray] = {}
        self._req_params: Dict[int, dict] = {}
        self._next_rid = 0
        self._admit_seq = 0
        # bumped by every slot release: the async pipeline drains when a
        # page may have been freed under its in-flight bursts
        self._release_gen = 0
        self._gen = torch.Generator(device=dev)
        self._gen.manual_seed(int(seed))
        self._buf = _LaunchBuffers(max_batch, self.pages_per_seq,
                                   self.decode_burst, dev)
        self._host = [_HostSlot(max_batch, self.decode_burst, dev)
                      for _ in range(self.async_depth + 2)]
        self._graphs = dev.type == "cuda" and self.decode_burst > 1
        self._burst_fns: Dict[tuple, object] = {}
        # what ran: batched prefill calls, decode steps (one a token step:
        # k a dispatch of k), preemptions, graph captures and replays, and
        # tokens a program emitted for a row the host had already finished
        # or aborted (0 without aborts: the programs' finish rules are the
        # host's)
        self.prefills = 0
        self.decode_steps = 0
        self.preemptions = 0
        self.graph_captures = 0
        self.graph_replays = 0
        self.discarded_tokens = 0

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------
    def add_request(self, prompt_ids, max_new_tokens=32,
                    decode_strategy=None, temperature=None, top_k=None,
                    top_p=None, eos_token_id=None, on_token=None) -> int:
        """Queue a request; sampling parameters default to the engine's.
        on_token(rid, token) is called on the host as each token is
        committed, in order (tokens already streamed are not re-streamed
        after a preemption); it may call `abort`."""
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
        """Admit every request that fits into a free slot, in the policy's
        order, then prefill them all in one batched call."""
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

    def warmup(self, prompt_len=None, sampling=None):
        """Build every decode program before traffic: one throwaway greedy
        request end to end (its prefill bucket and, at decode_burst > 1, a
        full burst), a second one of 2 tokens for the single-step program,
        and the same with sampling when `sampling` (default: whenever the
        engine's decode_strategy samples). On CUDA with decode_burst > 1
        this captures the graphs. The engine must be idle. With
        FLAGS_autotune on, the decode bucket is tuned first (a tuner
        failure raises). Returns wall seconds."""
        if self.has_work():
            raise RuntimeError(
                "warmup() must run on an idle engine: queued/active "
                "requests would be decoded and their outputs discarded")
        if sampling is None:
            sampling = self.decode_strategy != "greedy_search"
        t0 = time.perf_counter()
        # the first token comes from the prefill, so a burst engine asks
        # for decode_burst + 1 to run one full burst
        max_new = self.decode_burst + 1
        plen = int(prompt_len) if prompt_len is not None else max(
            1, min(self.page_size, self.max_seq_len - max_new))
        if prompt_len is not None and self.decode_burst > 1 and \
                plen + max_new > self.max_seq_len:
            raise ValueError(
                f"warmup(prompt_len={plen}) leaves no room for a "
                f"decode_burst={self.decode_burst} budget within "
                f"max_seq_len={self.max_seq_len}: the burst program would "
                f"not be built and the first real request would pay for "
                f"it. Use a shorter prompt_len (<= "
                f"{self.max_seq_len - max_new}) or a smaller decode_burst.")
        max_new = max(2, min(max_new, self.max_seq_len - plen))
        self._autotune_decode_bucket()
        budgets = [max_new] + ([2] if self.decode_burst > 1 and max_new > 2
                               else [])
        strategies = ["greedy_search"] + (["sampling"] if sampling else [])
        for strategy in strategies:
            for mx in budgets:
                # eos -1 matches no token: the request reaches decode
                self.add_request(np.zeros((plen,), np.int64),
                                 max_new_tokens=mx, decode_strategy=strategy,
                                 eos_token_id=-1)
                self.run()
        return time.perf_counter() - t0

    def _autotune_decode_bucket(self):
        """With FLAGS_autotune on (or readonly), resolve the paged-decode
        winner for this engine's cache geometry ahead of traffic. Unlike
        the reference this catches nothing: a tuner failure raises."""
        if not _at.enabled():
            return
        kvh, _n, page, hd = self.k_pages[0].shape
        _at.choose_paged_decode(
            self.max_batch, self.cfg.num_attention_heads, kvh, hd, page,
            self.pages_per_seq, self.k_pages[0].dtype,
            self.kv_cache_quant == "int8")

    # ------------------------------------------------------------------
    # pages
    # ------------------------------------------------------------------
    def _release_slot(self, slot_idx):
        s = self.slots[slot_idx]
        self._free_pages.extend(
            self.block_tables[slot_idx, :s.n_pages].tolist())
        s.n_pages = 0
        s.active = False
        self._release_gen += 1

    def abort(self, request_id: int) -> bool:
        """Drop a request: dequeue it if pending, or free its slot and pages
        if running (safe from an on_token callback, also in the middle of a
        burst's replay). Returns whether it was found. Nothing is emitted
        for an aborted request."""
        for i, (rid, *_rest) in enumerate(self._pending):
            if rid == request_id:
                self._pending.pop(i)
                self._prompts.pop(request_id, None)
                self._req_params.pop(request_id, None)
                return True
        for idx, s in enumerate(self.slots):
            if s.active and s.request_id == request_id:
                self._release_slot(idx)
                self._prompts.pop(request_id, None)
                self._req_params.pop(request_id, None)
                return True
        return False

    def _ensure_pages(self, slot_idx, steps) -> bool:
        """Grow the slot's pages to cover `steps` more tokens (1 a step, up
        to the burst length); False when the pool is empty (the caller
        preempts)."""
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
    # prefill
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
            if self.kv_cache_quant:
                _pa.prefill_paged_kv_cache_q8(
                    self.k_pages[li], self.k_scales[li], self.v_pages[li],
                    self.v_scales[li], kc[:n], vc[:n], tables, lens)
            else:
                _pa.prefill_paged_kv_cache(self.k_pages[li],
                                           self.v_pages[li], kc[:n], vc[:n],
                                           tables, lens)
        del caches
        first = first.cpu().numpy()
        for row, (si, _) in enumerate(new):
            self.slots[si].first_token = int(first[row])
        self.prefills += 1

    # ------------------------------------------------------------------
    # decode programs
    # ------------------------------------------------------------------
    def _decode_step_core(self, all_greedy):
        """One single-token decode step over the launch buffers (forward
        through the paged caches, then sampling), shared by every program:
        the one place the decode semantics live. `all_greedy` skips the
        per-row sampler."""
        b, model, caches, gen = self._buf, self.model, self._caches, self._gen
        scratch = self._scratch

        def core(tok, lens, act):
            logits, _ = model.forward_paged(tok[:, None], caches, b.tables,
                                            lens, active=act,
                                            scratch_page=scratch)
            if all_greedy:
                return sample_logits(logits[:, 0], gen, "greedy_search")[0]
            return sample_logits_per_row(logits[:, 0], gen, b.greedy, b.temp,
                                         b.top_k, b.top_p)[0]

        return core

    def _burst_body(self, all_greedy, k):
        """The k-step program: `burst_rules` after each step, the k steps'
        tokens and emit flags into the buffers, the final carry back into
        the launch state."""
        b = self._buf
        core = self._decode_step_core(all_greedy)

        @torch.no_grad()
        def body():
            tok, lens, act, rem = b.tok, b.lens, b.act, b.rem
            toks, emits = [], []
            for _ in range(k):
                nxt = core(tok, lens, act)
                tok, lens, act, rem, emitted = burst_rules(
                    tok, lens, act, rem, nxt, b.eos)
                toks.append(nxt)
                emits.append(emitted)
            b.toks[:k] = torch.stack(toks)
            b.emits[:k] = torch.stack(emits)
            for dst, src in ((b.tok, tok), (b.lens, lens), (b.act, act),
                             (b.rem, rem)):
                dst.copy_(src)

        return body

    def _get_burst_fn(self, all_greedy, k):
        """The (all_greedy, k) decode program, built at its first use: on
        CUDA with decode_burst > 1 a captured graph's replay, else the
        eager body."""
        key = (bool(all_greedy), int(k))
        fn = self._burst_fns.get(key)
        if fn is None:
            body = self._burst_body(*key)
            fn = self._capture(body, key[0]) if self._graphs else body
            self._burst_fns[key] = fn
        return fn

    def _capture(self, body, all_greedy):
        """Capture `body` as a CUDA graph (PyTorch's recipe): one eager call
        first, every row inactive, on a side stream (it loads the kernels,
        fills the tuner's memo and sizes the workspaces, and writes only
        the scratch page), then the capture. A failure raises; nothing
        falls back to eager decode on the card."""
        dev = self.device
        self._buf.idle()
        cur = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            body()
        cur.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        if not all_greedy:
            # each replay then advances the generator it draws from
            graph.register_generator_state(self._gen)
        with torch.cuda.graph(graph):
            body()
        self.graph_captures += 1

        def replay():
            graph.replay()
            self.graph_replays += 1

        return replay

    def _put_tables(self):
        """The host block table into the program's static copy (before
        every dispatch: pages grow between them)."""
        self._buf.tables.copy_(torch.from_numpy(self.block_tables),
                               non_blocking=True)

    def _launch(self, fn, k, n):
        """Dispatch program `fn` of k steps: tables in, run, tokens and emit
        flags out to host slot n (mod the ring), its event recorded.
        Returns (host slot, k) for `_harvest`."""
        h = self._host[n % len(self._host)]
        self._put_tables()
        fn()
        b = self._buf
        h.toks[:k].copy_(b.toks[:k], non_blocking=True)
        h.emits[:k].copy_(b.emits[:k], non_blocking=True)
        if h.event is not None:
            h.event.record()
        self.decode_steps += k
        return h, k

    @staticmethod
    def _harvest(h, k):
        """Wait for a dispatch's host copies; its [k, B] tokens and emit
        flags as numpy."""
        if h.event is not None:
            h.event.synchronize()
        return h.toks[:k].numpy(), h.emits[:k].numpy()

    # ------------------------------------------------------------------
    # decode
    # ------------------------------------------------------------------
    def _rem_of(self, active):
        """Remaining new-token budget per active slot: the one place the
        budget rule lives (burst sizing, page reservation and the device's
        rem all derive from it)."""
        return {i: self.slots[i].max_new_tokens - len(self.slots[i].tokens)
                for i in active}

    def _req_eos(self, rid):
        rp = self._req_params.get(rid)
        return rp["eos"] if rp is not None else self.eos_token_id

    def _decode_launch_state(self, active):
        """Per-row launch arrays of a decode dispatch, shared by the sync and
        async paths."""
        defaults = dict(greedy=True, temperature=1.0, top_k=0, top_p=1.0)

        def rp(s):
            return self._req_params.get(s.request_id, defaults) \
                if s.active else defaults

        rem_of = self._rem_of(active)
        act_mask = np.asarray([s.active and i in active
                               for i, s in enumerate(self.slots)], bool)
        return dict(
            rem_of=rem_of,
            act_mask=act_mask,
            lens=np.asarray([s.context_len if s.active else 0
                             for s in self.slots], np.int32),
            all_greedy=all(self.slots[i].greedy for i in active),
            greedy=np.asarray([rp(s)["greedy"] for s in self.slots], bool),
            temp=np.asarray([rp(s)["temperature"] for s in self.slots],
                            np.float32),
            tk=np.asarray([rp(s)["top_k"] for s in self.slots], np.int64),
            tp=np.asarray([rp(s)["top_p"] for s in self.slots], np.float32),
            rem=np.asarray([max(rem_of.get(i, 0), 0) if act_mask[i] else 0
                            for i in range(self.max_batch)], np.int32),
            eos=np.asarray([e if s.active and
                            (e := self._req_eos(s.request_id)) is not None
                            else -1 for s in self.slots], np.int64))

    def _stream(self, rid, token):
        """The one commit point of a token into its request's stream."""
        rp = self._req_params.get(rid)
        cb = rp["on_token"] if rp is not None else None
        if cb is not None:
            cb(rid, int(token))

    def _done(self, s) -> bool:
        eos = self._req_eos(s.request_id)
        return len(s.tokens) >= s.max_new_tokens or (
            eos is not None and s.tokens[-1] == eos)

    @torch.no_grad()
    def step(self) -> List[FinishedRequest]:
        """Admit and prefill what fits, then one decode dispatch (k steps,
        the policy's `burst_k`) for every active slot. Returns the requests
        that finished in this step."""
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
                s.tokens.append(s.first_token)
                self._stream(s.request_id, s.first_token)
                if s.active and self._done(s):
                    first_done.append(i)
            tokens[i] = s.tokens[-1]
        finished = [self._finish(i) for i in first_done]
        # (a callback may have aborted a request)
        active = [i for i in active if self.slots[i].active]
        if not active:
            if finished:
                self._admit()
            return finished
        rem_of = self._rem_of(active)
        k = self.decode_burst \
            if int(self.scheduler.burst_k(self, active, rem_of)) > 1 else 1
        # on-demand pages for the positions this dispatch writes; an empty
        # pool preempts the policy's victim and retries
        while True:
            stalled = [i for i in active
                       if not self._ensure_pages(i, min(k, rem_of[i]))]
            if not stalled:
                break
            victim = self.scheduler.select_victim(self, stalled,
                                                  "page_stall")
            self._preempt(victim)
            active = [i for i in active if i != victim]
            if not active:
                return finished
        st = self._decode_launch_state(active)
        fn = self._get_burst_fn(st["all_greedy"], k)
        self._buf.stage(st, tokens)
        toks, emits = self._harvest(*self._launch(fn, k, 0))
        finished.extend(self._replay_burst(toks, emits, active))
        if finished:
            self._admit()
        return finished

    def _replay_burst(self, toks, emits, active):
        """Token-by-token host replay of one dispatch's [k, B] tokens and
        emit flags: the streams, callbacks and finishes of k single steps
        (an abort from a callback drops the rest of that request's
        tokens)."""
        finished = []
        for j in range(toks.shape[0]):
            for i in active:
                if not emits[j, i]:
                    continue
                s = self.slots[i]
                if not s.active:
                    self.discarded_tokens += 1
                    continue
                s.context_len += 1  # the fed token is now cached
                s.tokens.append(int(toks[j, i]))
                self._stream(s.request_id, s.tokens[-1])
                if s.active and self._done(s):
                    finished.append(self._finish(i))
        return finished

    def _async_ok(self) -> bool:
        """Pipelined decode runs only in pure decode: no queue (admission
        would reuse pages an in-flight burst may still write), no pending
        first tokens, and a row with more than one token of budget."""
        if self.async_depth <= 0 or self.decode_burst <= 1 or self._pending:
            return False
        active = [i for i, s in enumerate(self.slots) if s.active]
        if not active or any(self.slots[i].needs_first_sample
                             for i in active):
            return False
        return max(self._rem_of(active).values()) > 1

    @torch.no_grad()
    def _decode_async(self, max_bursts):
        """Dispatch up to `async_depth` bursts ahead of the one the host
        replays. Each burst replays off the previous one's carry in the
        buffers; pages are reserved for every in-flight burst plus the next
        (capped at each row's final context), and a finish or abort during
        a replay drains the pipeline before any page can be reused.
        Returns (finished, bursts dispatched)."""
        k = self.decode_burst
        active = [i for i, s in enumerate(self.slots) if s.active]
        st = self._decode_launch_state(active)
        rem_of = st["rem_of"]
        n_bursts = min(int(max_bursts), -(-max(rem_of.values()) // k))
        if n_bursts <= 0:
            return [], 0
        fn = self._get_burst_fn(st["all_greedy"], k)
        tokens = np.zeros((self.max_batch,), np.int64)
        for i in active:
            tokens[i] = self.slots[i].tokens[-1]
        final_ctx = {i: self.slots[i].context_len + rem_of[i]
                     for i in active}
        self._buf.stage(st, tokens)
        inflight = deque()
        finished = []
        dispatched = 0
        stop = False

        def reserve():
            for i in active:
                s = self.slots[i]
                if not s.active:
                    continue
                steps = min(k * (len(inflight) + 1),
                            final_ctx[i] - s.context_len)
                if steps > 0 and not self._ensure_pages(i, steps):
                    return False
            return True

        while (dispatched < n_bursts and not stop) or inflight:
            if dispatched < n_bursts and not stop:
                if reserve():
                    inflight.append(self._launch(fn, k, dispatched))
                    dispatched += 1
                else:
                    stop = True  # drain; step() then preempts
            if inflight and (stop or len(inflight) > self.async_depth
                             or dispatched >= n_bursts):
                toks, emits = self._harvest(*inflight.popleft())
                gen0 = self._release_gen
                finished.extend(self._replay_burst(toks, emits, active))
                if self._release_gen != gen0:
                    stop = True
        if finished:
            self._admit()
        return finished, dispatched

    def _finish(self, slot_idx) -> FinishedRequest:
        s = self.slots[slot_idx]
        self._release_slot(slot_idx)
        self._req_params.pop(s.request_id, None)
        prompt = self._prompts.pop(s.request_id)
        return FinishedRequest(request_id=s.request_id, prompt_ids=prompt,
                               output_ids=np.asarray(s.tokens, np.int64))

    def run(self, max_steps=10_000) -> List[FinishedRequest]:
        """Step until idle (or `max_steps` dispatches), through the async
        pipeline whenever `_async_ok`."""
        out = []
        steps = 0
        while self.has_work() and steps < max_steps:
            if self._async_ok():
                got, n = self._decode_async(max_steps - steps)
                if n > 0:
                    out.extend(got)
                    steps += n
                    continue
            out.extend(self.step())
            steps += 1
        return out
