"""Continuous-batching decoder over a paged KV cache (counterpart of
`ServingEngine` in `paddle_tpu/inference/serving.py`).

    engine = ServingEngine(model, max_batch=8, max_seq_len=4096,
                           decode_burst=8, async_depth=2)
    # or speculative: ServingEngine(model, ..., spec_decode=4), shallow
    # exit, or with draft_model=a_smaller_llama
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

Prefix cache (`prefix_cache=1`): the full pages of every prefilled prompt
enter a refcounted trie (`prefix_cache.PrefixCache`), and admission shares
the pages of the longest cached page-aligned prefix into the new row. A
page's count is one for the trie plus one for each row that holds it; it
is on the free list exactly at 0, and pages only the trie holds are
reclaimed least-recently-used when the pool runs short (`_avail_pages`,
`_reclaim_pages`). The scratch page is never on the free list, never
counted and never in the trie.

Chunked prefill (`prefill_chunk=N`, page-aligned): the prompt, or after a
cache hit only its uncached suffix, runs through the model's paged window
step in chunk rounds of at most N tokens (the policy's
`prefill_chunk_budget`), one round a step before the decode dispatch
(`_prefill_chunk_round`). A prefilling row stays inactive in the decode
programs (its writes go to the scratch page). A cache hit with chunking off
runs one round that covers the suffix. A round runs eagerly over the
prefilling rows alone; the last real position's logits sample the first
token. Greedy streams equal the JAX engine's either way.

Speculative decoding (`spec_decode=W`, W >= 2; greedy batches with more
than one token of budget left): a round drafts W - 1 tokens a row with a
cheap path, the target's first `spec_draft_layers` layers over their own
pages (shallow exit, half the depth by default) or a separate
`draft_model` over pools of its own (prefilled beside the target's; it
runs one draft step more, so that its last draft's K/V lands in its
pools), then verifies the window [last token, drafts] in one target
forward whose attention runs as W single-token decode rows a row through
the paged decode kernel (`paged_attention_window_rows`), each row's
context clamped to what it may commit. The host commits the accepted
prefix plus the target's corrected token (`_commit_spec`), so greedy
streams equal plain greedy decoding, up to near ties where the verify's
linears take another kernel than decode's (int8 weights: the dequant
matmul's m > 16 kernel at W * batch rows, its decode kernel at m <= 16)
and sum in another order. The draft program (one per scan
length) and the verify program read and write the same static buffers,
and on CUDA each is a captured graph whatever `decode_burst` is; a round
replays both back to back and reads the host once. Not with
`async_depth`.

Tensor parallelism (`mesh`, default the global mesh; its "tp" axis): one
engine a rank, as Paddle's predictor runs under fleet, where the reference
runs one engine over a device mesh. Each rank builds its model under the
mesh (`fleet.init` with `mp_degree`), so the model holds the rank's shards;
a model whose `tp_degree` is not the mesh's "tp" raises (the reference's
`place_model` reshards a whole model; the port builds shards at
construction). The rank's pools, and their int8 scale pools, hold kv_heads
/ tp heads (tp must divide the KV heads, as in the reference); the vocab
head's output is the rank's vocab shard, and every place that chooses a
token gathers the whole vocabulary first (`model.gather_logits`) on the
rows and positions it samples: the prefill's last real positions, a chunk
round's, a decode step's, a draft step's and the verify's window. Every
rank adds the same requests in the same order; the host state (admission,
pages, preemption victims, the trie, chunk rounds, speculative commits) is
a function of the requests and the committed tokens, and the committed
tokens are equal on every rank, since the gathered logits are and each
rank samples from a generator seeded alike. A rank whose decisions diverge
hangs its next collective. At tp > 1 no program is a CUDA graph: the
burst, draft and verify bodies run eagerly (the ranks' collectives on one
card go over gloo, which stages through the host and cannot be captured).

Not ported (the constructor accepts their defaults and raises on anything
else): the KV tiers; nor OOM recovery, handoff or telemetry.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np
import torch

from ..distributed import mesh as _mesh
from ..framework import config as _cfg
from ..framework.device import resolve_device
from ..kernels import autotune as _at
from ..kernels import paged_attention as _pa
from ..models.generation import sample_logits, sample_logits_per_row
from . import prefix_cache as _pc
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


def _tp_degree(mesh):
    """The "tp" axis's degree of a `DeviceMesh` (1 without a mesh or an
    axis of that name)."""
    if mesh is None:
        return 1
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        raise TypeError(f"ServingEngine(mesh=...) takes a DeviceMesh with "
                        f"named dimensions, got {type(mesh).__name__}")
    return int(mesh["tp"].size()) if "tp" in names else 1


def _kv_heads_of(model, tp, what="model"):
    """This rank's KV heads of `model` at degree `tp`: the config's (a
    config without num_key_value_heads, GPT, has one a query head) over
    tp. Raises, as the reference's engine does, where tp does not divide
    them, and where the model was built at another degree than the mesh's
    (the model must be built under the mesh, so that it holds its
    shards)."""
    cfg = model.config
    kvh = getattr(cfg, "num_key_value_heads", cfg.num_attention_heads)
    if tp > 1 and kvh % tp:
        raise ValueError(
            f"TP serving shards the {kvh} kv heads over tp={tp}; "
            f"the kv-head count must be divisible by tp")
    built = getattr(model, "tp_degree", 1)
    if built != tp:
        raise ValueError(
            f"ServingEngine: the {what} was built at tensor-parallel degree "
            f"{built} but the mesh's \"tp\" axis has degree {tp}; build it "
            f"under the mesh (fleet.init with mp_degree={tp}) so that it "
            f"holds this rank's shards")
    return kvh // tp


# constructor arguments of the reference whose features are not ported:
# (name, is the value the feature's off state, ROADMAP item)
_NOT_PORTED = (
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
    # chunked prefill: while `prefilling` the row owns its pages but is out
    # of decode; `_pf_ctx` is the whole context, of which context_len
    # tokens are cached so far; its suffix takes `_pf_n_chunks` rounds of
    # the configured width
    prefilling: bool = False
    _pf_ctx: object = None
    _pf_n_chunks: int = 0
    # speculative decoding: drafts this request could have committed, and
    # those the verify accepted (reset at admission)
    spec_proposed: int = 0
    spec_accepted: int = 0


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
    `emits[:k]`, and its final carry back into tok / lens / act / rem. A
    speculative round also stages `limit` (each row's last writable
    position plus one); its draft program writes `drafts[:n]` and its
    verify the window's greedy tokens `g`. Every program uses these same
    tensors, so a captured graph replays on whatever they hold."""

    def __init__(self, batch, pages_per_seq, k_max, dev, window=0):
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
        self.limit = new(0, torch.int32)
        self.drafts = new(0, torch.int64, max(window, 1), batch)
        self.g = new(0, torch.int64, batch, max(window, 1))

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
                     (self.tables, 0), (self.limit, 0), (self.drafts, 0)):
            t.fill_(v)


class _HostSlot:
    """Where one dispatch's tokens and emit flags (a speculative round's
    drafts and greedy tokens) land on the host: pinned on CUDA, with the
    event recorded after the copies."""

    def __init__(self, batch, k_max, dev, window=0):
        cuda = dev.type == "cuda"

        def new(dtype, *shape):
            return torch.zeros(shape, dtype=dtype, pin_memory=cuda)

        self.toks = new(torch.int64, k_max, batch)
        self.emits = new(torch.bool, k_max, batch)
        self.drafts = new(torch.int64, max(window, 1), batch)
        self.g = new(torch.int64, batch, max(window, 1))
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
        given = dict(kv_host_cache_mb=kv_host_cache_mb,
                     kv_disk_cache_dir=kv_disk_cache_dir)
        sd = int(spec_decode if spec_decode is not None
                 else _cfg.get_flag("FLAGS_spec_decode", 0))
        # the window: 0 (off) below 2
        self.spec_decode = sd if sd >= 2 else 0
        if self.spec_decode and int(async_depth) > 0:
            raise ValueError(
                "spec_decode and async_depth are mutually exclusive: the "
                "speculative round already keeps the device busy across the "
                "window, and the async pipeline's stale-carry pages cannot "
                "express the verify rewind")
        self._draft_model = draft_model if self.spec_decode else None
        pc = prefix_cache if prefix_cache is not None \
            else _cfg.get_flag("FLAGS_prefix_cache", 0)
        ck = int(prefill_chunk if prefill_chunk is not None
                 else _cfg.get_flag("FLAGS_prefill_chunk", 0))
        if (bool(int(pc)) or ck > 0) and self._draft_model is not None:
            raise ValueError(
                "prefix_cache / prefill_chunk cannot serve with a separate "
                "draft_model: the chunked continuation fills only the "
                "target's pages, so the draft pools would decode against an "
                "unwritten prompt")
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
        self.mesh = mesh if mesh is not None else _mesh.get_mesh(
            optional=True)
        self.tp = tp = _tp_degree(self.mesh)
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
        # references a page holds: one for each row that holds it, one for
        # the trie; a page is on the free list exactly when its count is 0
        self._page_refs = [0] * n_pages
        # one more page in each pool: the scratch page inactive rows write
        # (never on the free list, never counted, never in the trie)
        self._scratch = n_pages
        self.prefix_cache_enabled = bool(int(pc))
        # page-aligned: a chunk writes whole pages of window positions
        self.prefill_chunk = -(-ck // page_size) * page_size if ck > 0 \
            else 0
        # the trie mutates the two lists above in place (never rebind them)
        self._prefix_cache = _pc.PrefixCache(
            page_size, self._page_refs, self._free_pages) \
            if self.prefix_cache_enabled else None
        # this engine's token tallies: prompt tokens served from the trie
        # and prompt tokens prefilled, counted at admission
        self._prefix_hits_total = 0
        self._prefix_misses_total = 0
        hd = cfg.hidden_size // cfg.num_attention_heads
        # a config without num_key_value_heads (GPT) has one KV head a
        # query head, as the reference reads it; each rank's pools hold
        # its kv_heads / tp
        kvh = _kv_heads_of(model, tp)
        L = cfg.num_hidden_layers
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
        # speculative decoding: the shallow-exit draft runs the target's
        # first spec_draft_layers layers over their own pages (half the
        # depth by default); a separate draft model decodes the same
        # positions through the same block tables and lengths, over pools
        # of its own (float or int8, and one scratch page like the
        # target's)
        self._draft_caches = None
        if self._draft_model is not None:
            self.spec_draft_layers = None
            dcfg = self._draft_model.config
            dparam = next(self._draft_model.parameters())
            if dparam.device != dev:
                raise ValueError(f"the draft model lives on {dparam.device} "
                                 f"but the engine serves on {dev}")
            dkvh = _kv_heads_of(self._draft_model, tp, "draft model")
            dhd = dcfg.hidden_size // dcfg.num_attention_heads
            d_dtype = torch.int8 if kv_cache_quant else dparam.dtype
            self._draft_caches = []
            for _ in range(dcfg.num_hidden_layers):
                kp, vp = _pa.alloc_pages(n_pages + 1, page_size, dkvh, dhd,
                                         d_dtype, dev)
                sc = _pa.alloc_page_scales(n_pages + 1, page_size, dkvh,
                                           dev) if kv_cache_quant else ()
                self._draft_caches.append((kp, vp, *sc))
        else:
            dl = int(spec_draft_layers if spec_draft_layers is not None
                     else _cfg.get_flag("FLAGS_spec_draft_layers", 0))
            self.spec_draft_layers = max(1, min(dl if dl > 0
                                                else -(-L // 2), L))
        self._spec_draft_fns: Dict[int, object] = {}
        self._spec_verify_fns: Dict[int, object] = {}
        # this engine's tallies of drafts proposed and accepted
        self._spec_proposed_total = 0
        self._spec_accepted_total = 0
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
                                   self.decode_burst, dev, self.spec_decode)
        self._host = [_HostSlot(max_batch, self.decode_burst, dev,
                                self.spec_decode)
                      for _ in range(self.async_depth + 2)]
        # no CUDA graph at tp > 1: the programs hold the ranks' collectives
        # (the class docstring)
        self._graphs = dev.type == "cuda" and self.decode_burst > 1 \
            and tp == 1
        # the speculative programs are graphs on CUDA whatever decode_burst
        self._spec_graphs = dev.type == "cuda" and tp == 1
        self._burst_fns: Dict[tuple, object] = {}
        # what ran: batched prefill calls, chunk rounds, decode steps (one
        # a token step: k a dispatch of k), speculative rounds,
        # preemptions, graph captures and replays, and tokens a program
        # emitted for a row the host had already finished or aborted (0
        # without aborts: the programs' finish rules are the host's)
        self.prefills = 0
        self.chunk_rounds = 0
        self.decode_steps = 0
        self.spec_rounds = 0
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

    def admit_pending(self):
        """One admission round without decoding: the batched prefill of
        what fits, and the chunk rounds of rows on the chunked route (a
        cache hit, or chunking on) run to their end."""
        self._admit()
        while True:
            pf = [i for i, s in enumerate(self.slots)
                  if s.active and s.prefilling]
            if not pf:
                break
            self._prefill_chunk_round(pf)

    def _admit(self):
        """Admit every request that fits into a free slot, in the policy's
        order. A prefix-cache match shares its pages into the row; rows on
        the chunked route (a match, or chunking on) prefill in chunk
        rounds, the others all in one batched call."""
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
            # take the matched pages' references first, so that the reclaim
            # below cannot evict the pages this admission is about to share
            cached_pages, cached_tokens = [], 0
            if self._prefix_cache is not None:
                cached_pages, cached_tokens = self._prefix_cache.match(ctx)
                for p in cached_pages:
                    self._page_refs[p] += 1
            need_fresh = need - len(cached_pages)
            if len(self._free_pages) < need_fresh:
                self._reclaim_pages(need_fresh - len(self._free_pages))
            if len(self._free_pages) < need_fresh:
                for p in cached_pages:  # roll the tentative references back
                    self._page_refs[p] -= 1
                break
            self._pending.pop(pick)
            pages = cached_pages + [self._alloc_page()
                                    for _ in range(need_fresh)]
            self.block_tables[slot_idx, :need] = np.asarray(pages, np.int32)
            s = self.slots[slot_idx]
            s.request_id, s.tokens = rid, list(prior)
            s.max_new_tokens = max_new
            s.n_pages = need
            s.greedy = self._req_params[rid]["greedy"]
            s.admit_seq = self._admit_seq
            self._admit_seq += 1
            s.spec_proposed = 0
            s.spec_accepted = 0
            if self._prefix_cache is not None:
                self._prefix_hits_total += cached_tokens
                self._prefix_misses_total += len(ctx) - cached_tokens
            if self.prefill_chunk or cached_tokens:
                # the chunked route: only the uncached suffix runs, in
                # chunk rounds between decode dispatches; the row is out of
                # decode until the suffix is cached
                s.context_len = cached_tokens
                s.prefilling = True
                s._pf_ctx = ctx
                s.needs_first_sample = False
                suffix = len(ctx) - cached_tokens
                cw = self.prefill_chunk or \
                    -(-suffix // self.page_size) * self.page_size
                s._pf_n_chunks = -(-suffix // cw)
            else:
                s.context_len = len(ctx)
                s.prefilling = False
                s.needs_first_sample = True
                new.append((slot_idx, ctx))
            s.active = True
        if new:
            self._prefill_batch(new)

    def refresh_params(self):
        """Take the model's weights as they are now (after a live reload).
        The engine keeps no copy: the eager programs and the captured
        graphs read the model's own parameter tensors, which
        `weights.load_llama_state` / `load_gpt_state` update in place, so
        there is nothing to drop. A reload that rebinds a parameter to a
        new tensor instead needs a new engine, since a captured graph keeps
        the addresses it was captured with."""

    def warmup(self, prompt_len=None, sampling=None):
        """Build every decode program before traffic: one throwaway greedy
        request end to end (its prefill bucket and, at decode_burst > 1, a
        full burst; with spec_decode, a speculative round: its draft and
        verify programs), a second one of 2 tokens for the single-step
        program, and the same with sampling when `sampling` (default:
        whenever the engine's decode_strategy samples). On CUDA with
        decode_burst > 1 this captures the burst graphs, and with
        spec_decode the draft and verify graphs. The engine must be idle.
        With FLAGS_autotune on, the decode buckets are tuned first (a tuner
        failure raises). Returns wall seconds."""
        if self.has_work():
            raise RuntimeError(
                "warmup() must run on an idle engine: queued/active "
                "requests would be decoded and their outputs discarded")
        if sampling is None:
            sampling = self.decode_strategy != "greedy_search"
        t0 = time.perf_counter()
        # the first token comes from the prefill, so a burst engine asks
        # for decode_burst + 1 to run one full burst, a speculative one for
        # window + 1 to run a whole round
        max_new = max(self.decode_burst, self.spec_decode) + 1
        plen = int(prompt_len) if prompt_len is not None else max(
            1, min(self.page_size, self.max_seq_len - max_new))
        if prompt_len is not None and \
                (self.decode_burst > 1 or self.spec_decode) and \
                plen + max_new > self.max_seq_len:
            raise ValueError(
                f"warmup(prompt_len={plen}) leaves no room for a "
                f"decode_burst={self.decode_burst} / "
                f"spec_decode={self.spec_decode} budget within "
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
        winner for this engine's cache geometry ahead of traffic: the
        decode's max_batch rows and, with spec_decode, the verify's
        max_batch * window rows (and a draft model's geometry), at this
        rank's head counts. Unlike the reference this catches nothing: a
        tuner failure raises."""
        if not _at.enabled():
            return
        quant = self.kv_cache_quant == "int8"
        buckets = [(self.cfg, self.k_pages[0], self.max_batch)]
        if self.spec_decode:
            buckets.append((self.cfg, self.k_pages[0],
                            self.max_batch * self.spec_decode))
        if self._draft_model is not None:
            buckets.append((self._draft_model.config,
                            self._draft_caches[0][0], self.max_batch))
        for cfg, pages, rows in buckets:
            # this rank's heads: its query heads over its pools' KV heads
            kvh, _n, page, hd = pages.shape
            _at.choose_paged_decode(rows, cfg.num_attention_heads // self.tp,
                                    kvh, hd, page, self.pages_per_seq,
                                    pages.dtype, quant)

    # ------------------------------------------------------------------
    # pages
    # ------------------------------------------------------------------
    def _alloc_page(self) -> int:
        page = self._free_pages.pop()
        self._page_refs[page] += 1
        return page

    def _decref_page(self, page):
        page = int(page)
        self._page_refs[page] -= 1
        if self._page_refs[page] == 0:
            self._free_pages.append(page)

    def _avail_pages(self) -> int:
        """Pages admission may count on: the free list plus the pages
        only the trie holds (reclaimed on demand). len(_free_pages) with
        the cache off."""
        n = len(self._free_pages)
        if self._prefix_cache is not None:
            n += self._prefix_cache.evictable()
        return n

    def _reclaim_pages(self, need: int) -> int:
        """Evict up to `need` pages only the trie holds back to the free
        list (least recently used first); returns the pages freed."""
        if self._prefix_cache is None or need <= 0:
            return 0
        return self._prefix_cache.evict(need)

    def _release_slot(self, slot_idx):
        """Drop a row's reference on each of its pages and deactivate it
        (finish, preemption, abort). A page reaches the free list at count
        0; pages the trie still holds stay for the next match."""
        s = self.slots[slot_idx]
        for page in self.block_tables[slot_idx, :s.n_pages].tolist():
            self._decref_page(page)
        s.n_pages = 0
        s.active = False
        s.prefilling = False
        s._pf_ctx = None
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
            if not self._free_pages and not self._reclaim_pages(1):
                return False
            self.block_tables[slot_idx, s.n_pages] = self._alloc_page()
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
        ids = torch.from_numpy(padded).to(dev)
        caches = self.model.init_kv_caches(nb, bucket)
        logits, caches = self.model.forward_cached(ids, caches, 0)
        # causal: position true_len - 1 never saw the padding
        last = self.model.gather_logits(
            logits[torch.arange(nb, device=dev),
                   torch.from_numpy(true_lens - 1).to(dev)])
        first = self._sample(last, all_greedy, params)
        tables = torch.from_numpy(
            self.block_tables[[si for si, _ in new]]).to(dev)
        lens = torch.from_numpy(true_lens[:n])  # host: masks without a sync
        self._write_prompts(self._caches, caches, tables, lens, n)
        del caches
        if self._draft_model is not None:
            # the draft model needs the prompts in its own pools too (its
            # sample is not used)
            dcaches = self._draft_model.init_kv_caches(nb, bucket)
            _, dcaches = self._draft_model.forward_cached(ids, dcaches, 0)
            self._write_prompts(self._draft_caches, dcaches, tables, lens,
                                n)
            del dcaches
        if self._prefix_cache is not None:
            # the full pages enter the trie; the partial tail page never
            # does (decode keeps appending to it, in this row alone)
            for si, ids in new:
                self._prefix_cache.insert(ids, self.block_tables[si])
        first = first.cpu().numpy()
        for row, (si, _) in enumerate(new):
            self.slots[si].first_token = int(first[row])
        self.prefills += 1

    @staticmethod
    def _write_prompts(pools, caches, tables, lens, n):
        """The first n rows of a dense prefill's per-layer (k, v) caches
        into the page pools (per layer (k, v) or (k, v, k_scales,
        v_scales))."""
        for pool, (kc, vc) in zip(pools, caches):
            if len(pool) == 4:
                kp, vp, ks, vs = pool
                _pa.prefill_paged_kv_cache_q8(kp, ks, vp, vs, kc[:n],
                                              vc[:n], tables, lens)
            else:
                _pa.prefill_paged_kv_cache(pool[0], pool[1], kc[:n], vc[:n],
                                           tables, lens)

    @torch.no_grad()
    def _prefill_chunk_round(self, pf):
        """One chunk for every prefilling row in one window forward over
        those rows alone (`forward_paged` at s = width, positions past a
        row's take masked by `limit_lens`). The width is the policy's
        `prefill_chunk_budget`, page-aligned and capped at prefill_chunk;
        with chunking off (a cache-hit continuation) one chunk covers the
        longest suffix. A row whose suffix completes enters the trie and
        hands the sample of its last real position to the first-token path
        of this same step. Admission allocated every prompt page, so no
        page grows here. Runs eagerly: a round has enough work a launch."""
        rem = {i: len(self.slots[i]._pf_ctx) - self.slots[i].context_len
               for i in pf}
        if self.prefill_chunk:
            c = int(self.scheduler.prefill_chunk_budget(self, pf))
            c = max(self.page_size, min(c, self.prefill_chunk))
        else:
            c = max(rem.values())
        c = -(-c // self.page_size) * self.page_size
        n = len(pf)
        win = np.zeros((n, c), np.int64)
        lens = np.zeros((n,), np.int32)
        take = np.zeros((n,), np.int32)
        for row, i in enumerate(pf):
            s = self.slots[i]
            take[row] = min(c, rem[i])
            win[row, :take[row]] = \
                s._pf_ctx[s.context_len:s.context_len + take[row]]
            lens[row] = s.context_len
        rids = [self.slots[i].request_id for i in pf]
        all_greedy = all(self.slots[i].greedy for i in pf)
        dev = self.device
        # lens and limit stay on the host: the window attention reads them
        # there without a sync
        lens_t = torch.from_numpy(lens)
        logits, _ = self.model.forward_paged(
            torch.from_numpy(win).to(dev), self._caches,
            torch.from_numpy(self.block_tables[pf]).to(dev), lens_t,
            scratch_page=self._scratch,
            limit_lens=lens_t + torch.from_numpy(take))
        # the last real position of each row
        last = self.model.gather_logits(
            logits[torch.arange(n, device=dev),
                   torch.from_numpy(take.astype(np.int64) - 1).to(dev)])
        first = self._sample(last, all_greedy, self._row_params(rids))
        first = first.cpu().numpy()
        self.chunk_rounds += 1
        for row, i in enumerate(pf):
            s = self.slots[i]
            s.context_len += int(take[row])
            if s.context_len >= len(s._pf_ctx):
                if self._prefix_cache is not None:
                    self._prefix_cache.insert(s._pf_ctx,
                                              self.block_tables[i])
                s.first_token = int(first[row])
                s.needs_first_sample = True
                s.prefilling = False
                s._pf_ctx = None

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
            logits = model.gather_logits(logits[:, 0])
            if all_greedy:
                return sample_logits(logits, gen, "greedy_search")[0]
            return sample_logits_per_row(logits, gen, b.greedy, b.temp,
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
    # speculative decoding: draft cheaply, verify the window in one target
    # forward, commit the greedy-exact accepted prefix plus one token
    # ------------------------------------------------------------------
    def _spec_draft_body(self, n):
        """The n-step draft program: n greedy single-token steps from the
        launch state (tok = where(active, next, tok), lens += active), each
        token's K/V written at its position (a position at or past `limit`
        writes the scratch page), the n drafts into `drafts[:n]`. Shallow
        exit runs the target's first spec_draft_layers layers over their
        own pages (the verify overwrites them); a draft model runs over its
        own pools. The launch state is left as it was."""
        b, scratch = self._buf, self._scratch
        if self._draft_model is not None:
            model, caches, depth = self._draft_model, self._draft_caches, \
                None
        else:
            depth = self.spec_draft_layers
            model, caches = self.model, self._caches[:depth]

        @torch.no_grad()
        def body():
            tok, lens, act = b.tok, b.lens, b.act
            drafts = []
            for _ in range(n):
                logits, _ = model.forward_paged(
                    tok[:, None], caches, b.tables, lens, active=act,
                    scratch_page=scratch, limit_lens=b.limit,
                    max_layers=depth)
                nxt = model.gather_logits(logits[:, 0]).float().argmax(
                    dim=-1)
                tok = torch.where(act, nxt, tok)
                lens = lens + act.to(lens.dtype)
                drafts.append(nxt)
            b.drafts[:n] = torch.stack(drafts)

        return body

    def _spec_verify_body(self, window):
        """The verify program: one target forward over the window [last
        token, drafts[:window - 1]] at positions lens..lens + window - 1
        (positions at or past `limit` write the scratch page; attention as
        decode rows, `paged_attention_window_rows`), the greedy token of
        every position into `g`."""
        b, model, caches, scratch = self._buf, self.model, self._caches, \
            self._scratch

        @torch.no_grad()
        def body():
            win = torch.cat([b.tok[:, None], b.drafts[:window - 1].t()],
                            dim=1)
            logits, _ = model.forward_paged(
                win, caches, b.tables, b.lens, active=b.act,
                scratch_page=scratch, limit_lens=b.limit, window_rows=True)
            b.g.copy_(model.gather_logits(logits).float().argmax(dim=-1))

        return body

    def _get_spec_draft_fn(self, n):
        """The n-step draft program, built at its first use: on CUDA a
        captured graph's replay, else the eager body."""
        fn = self._spec_draft_fns.get(n)
        if fn is None:
            body = self._spec_draft_body(n)
            fn = self._capture(body, True) if self._spec_graphs else body
            self._spec_draft_fns[n] = fn
        return fn

    def _get_spec_verify_fn(self, window):
        """The verify program of a window, built at its first use: on CUDA
        a captured graph's replay, else the eager body."""
        fn = self._spec_verify_fns.get(window)
        if fn is None:
            body = self._spec_verify_body(window)
            fn = self._capture(body, True) if self._spec_graphs else body
            self._spec_verify_fns[window] = fn
        return fn

    def _spec_window(self, active, rem_of):
        """This dispatch's speculative window, or 0 for the classic path:
        spec off, a sampling row in the batch (acceptance is greedy-exact
        prefix matching), or every row on its last token (nothing to
        draft)."""
        if self.spec_decode < 2 or max(rem_of.values()) <= 1:
            return 0
        if not all(self.slots[i].greedy for i in active):
            return 0
        return self.spec_decode

    def _dispatch_spec(self, window, active, st, tokens):
        """One speculative round for the active rows (their pages for
        min(window, rem) positions are reserved): the launch state and
        `limit` = lens + min(rem, window) staged, the draft program and the
        verify program run back to back with no host read between them,
        the drafts and greedy tokens copied out once and one event waited
        on, then the host commit. A separate draft model runs one draft
        step more than shallow exit, so that the last draft's K/V lands in
        its own pools (the verify never writes them). Returns the requests
        it finished."""
        n_scan = window - 1 if self._draft_model is None else window
        # built (on CUDA: captured, which idles the buffers) before staging
        draft_fn = self._get_spec_draft_fn(n_scan)
        verify_fn = self._get_spec_verify_fn(window)
        b, h = self._buf, self._host[0]
        limit = (st["lens"] + np.minimum(st["rem"], window)).astype(np.int32)
        b.stage(st, tokens)
        b.limit.copy_(torch.from_numpy(limit), non_blocking=True)
        self._put_tables()
        draft_fn()
        verify_fn()
        h.drafts.copy_(b.drafts, non_blocking=True)
        h.g.copy_(b.g, non_blocking=True)
        if h.event is not None:
            h.event.record()
            h.event.synchronize()
        self.spec_rounds += 1
        return self._commit_spec(h.drafts.numpy(), h.g.numpy(), active,
                                 window)

    def _commit_spec(self, drafts, g, active, window):
        """Host replay of one speculative round (the reference's). drafts:
        [n, B]; g: [B, window] the target's greedy tokens. A row commits
        g[0] and then g[j] for as long as draft j - 1 equals g[j - 1] (the
        stream plain greedy decoding gives), capped at its budget and cut
        after its eos; `proposed` counts the drafts it could have committed
        (min(window, rem) - 1). The rejected tail needs no rewind:
        context_len advances over committed tokens only, and the pages past
        it are rewritten before they are read. A request a callback aborts
        gets nothing more."""
        finished = []
        for i in active:
            s = self.slots[i]
            if not s.active:
                continue  # aborted from a callback
            committed = [int(g[i, 0])]
            for j in range(1, window):
                if int(drafts[j - 1, i]) != int(g[i, j - 1]):
                    break
                committed.append(int(g[i, j]))
            rem = s.max_new_tokens - len(s.tokens)
            committed = committed[:max(rem, 0)]
            eos = self._req_eos(s.request_id)
            if eos is not None and eos in committed:
                committed = committed[:committed.index(eos) + 1]
            accepted = max(len(committed) - 1, 0)
            proposed = max(min(window, rem) - 1, 0)
            s.spec_proposed += proposed
            s.spec_accepted += accepted
            self._spec_proposed_total += proposed
            self._spec_accepted_total += accepted
            for tok in committed:
                s.context_len += 1
                s.tokens.append(tok)
                self._stream(s.request_id, tok)
                if not s.active:
                    break  # the callback aborted this request
                if self._done(s):
                    finished.append(self._finish(i))
                    break
        return finished

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
        """Admit and prefill what fits, one chunk round for the rows on the
        chunked route, then one decode dispatch for every active slot that
        is not prefilling: a speculative round when `_spec_window` allows
        one, else k steps (the policy's `burst_k`). Returns the requests
        that finished in this step."""
        self._admit()
        pf = [i for i, s in enumerate(self.slots)
              if s.active and s.prefilling]
        if pf:
            self._prefill_chunk_round(pf)
        # a prefilling row has a partial context and no last token: it
        # stays inactive in the decode programs (its writes go to scratch)
        active = [i for i, s in enumerate(self.slots)
                  if s.active and not s.prefilling]
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
        # a speculative round replaces the burst when it can run
        spec_w = self._spec_window(active, rem_of)
        k = self.decode_burst \
            if int(self.scheduler.burst_k(self, active, rem_of)) > 1 else 1
        # on-demand pages for the positions this dispatch writes (a spec
        # round: min(window, rem)); an empty pool preempts the policy's
        # victim and retries
        reserve = spec_w or k
        while True:
            stalled = [i for i in active
                       if not self._ensure_pages(i, min(reserve, rem_of[i]))]
            if not stalled:
                break
            victim = self.scheduler.select_victim(self, stalled,
                                                  "page_stall")
            self._preempt(victim)
            active = [i for i in active if i != victim]
            if not active:
                return finished
        st = self._decode_launch_state(active)
        if spec_w:
            finished.extend(self._dispatch_spec(spec_w, active, st, tokens))
            if finished:
                self._admit()
            return finished
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
        first tokens, no row prefilling, and a row with more than one token
        of budget."""
        if self.async_depth <= 0 or self.decode_burst <= 1 or self._pending:
            return False
        active = [i for i, s in enumerate(self.slots) if s.active]
        if not active or any(self.slots[i].needs_first_sample
                             or self.slots[i].prefilling for i in active):
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
