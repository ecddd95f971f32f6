"""The port's prefix cache and chunked prefill against the JAX package's, on
the CPU in f32.

Layer by layer, the cases of the reference's `tests/test_prefix_cache.py`:

- `prefix_hash` and the trie (`PrefixCache`): the same operation sequences
  on both packages' tries give the same matches, evictions, refcounts and
  free lists;
- the window writers against `scatter_paged_kv_window(_q8)`: equal pools,
  with windows that overhang `limit_lens` and inactive rows; the window
  attention against `paged_attention_window_xla` within 1e-5 (f32), float
  and int8 pages; the model's paged step at s > 1 against the JAX model's
  (logits within 1e-4, pools within 1e-5, as `test_torch_model.py`);
- the engine (the reference's `_tiny_model`: vocab 97, hidden 32, 2
  layers, 4 heads, page 8) against the live JAX engine: every greedy
  stream equal, and the page invariant after every request, for sequential
  hits, chunk 8 with the cache, chunk 16 alone, int8 KV, preemption
  pressure, a randomized churn and a preemption that must be decref-aware.

Left out, with the features they need, which the port does not have:
`test_spec_decode_parity` (speculative decode), `TestDetachAttachShared
Pages` (KV handoff), the tiers' cases (the spill tiers), and the churn's
`_begin_recovery` step (OOM recovery; the churn here has every other op).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.inference import ServingEngine as JaxEngine
from paddle_tpu.inference import prefix_cache as jpc
from paddle_tpu.inference import scheduler as jsched
from paddle_tpu.kernels import paged_attention as jpa
from paddle_tpu.tensor import Tensor, as_array
from paddle_tpu_torch import get_flags, set_flags
from paddle_tpu_torch.inference import ServingEngine
from paddle_tpu_torch.inference import prefix_cache as tpc
from paddle_tpu_torch.inference import scheduler as tsched
from paddle_tpu_torch.kernels import paged_attention as tpa
from torch_parity import KV_HEADS, PAGE, serving_pair, tiny_pair

VOCAB = 97
KW = dict(max_batch=2, max_seq_len=64, page_size=8,
          decode_strategy="greedy_search")


# ---------------------------------------------------------------------------
# prefix_hash and the trie
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ids,page,max_pages", [
    ([1, 2, 3], 4, 4), ([], 4, 4), ([1, 2, 3, 4], 4, 4),
    (list(range(10)), 4, 4), (list(range(8)) + [99, 98], 4, 4),
    ([1, 2, 3, 5], 4, 4), (list(range(64)), 4, 4),
    (list(range(16)) + [7] * 48, 4, 4), (list(range(40)), 8, 2)])
def test_prefix_hash_matches_the_reference(ids, page, max_pages):
    want = jpc.prefix_hash(ids, page, max_pages=max_pages)
    assert tpc.prefix_hash(ids, page, max_pages=max_pages) == want
    assert (want is None) == (len(ids) < page)


def test_chain_digest_matches_the_reference():
    d_j = d_t = jpc._ROOT_DIGEST
    assert tpc._ROOT_DIGEST == d_j
    for chunk in ((1, 2, 3, 4), (5, 6, 7, 8), (0,) * 4):
        d_j, d_t = jpc._chain_digest(d_j, chunk), tpc._chain_digest(d_t,
                                                                    chunk)
        assert d_t == d_j


def _pool(n_pages):
    return [0] * n_pages, list(range(n_pages))[::-1]


def _invariant(refs, free, n_pages):
    """Every page is free (count 0) or referenced, never both or
    neither."""
    assert sorted(free) == sorted(set(free)), "duplicate free page"
    assert sum(1 for r in refs if r > 0) + len(free) == n_pages
    assert all(refs[p] == 0 for p in free)


def _take(refs, free, n):
    """n pages off the free list with a slot's reference each, as the
    engine takes them."""
    row = [free.pop() for _ in range(n)]
    for p in row:
        refs[p] += 1
    return row


def _roundtrip(pc, refs, free, log):
    trie = pc.PrefixCache(4, refs, free)
    ctx = list(range(10))  # 2 full pages and a partial tail
    row = _take(refs, free, 2)
    log.append(trie.insert(ctx, row))
    log.append((len(trie), sorted(trie.pages()), trie.match(ctx)))


def _whole_prompt(pc, refs, free, log):
    # an exact page multiple: the last page is recomputed, so that the
    # first sample has logits to come from
    trie = pc.PrefixCache(4, refs, free)
    ctx = list(range(8))
    trie.insert(ctx, _take(refs, free, 2))
    log.append(trie.match(ctx))


def _first_writer(pc, refs, free, log):
    trie = pc.PrefixCache(4, refs, free)
    ctx = list(range(8))
    row1, row2 = _take(refs, free, 2), _take(refs, free, 2)
    log.append((trie.insert(ctx, row1), trie.insert(ctx, row2)))
    log.append(trie.match(ctx))


def _lru_leaf(pc, refs, free, log):
    trie = pc.PrefixCache(4, refs, free)
    old, hot = list(range(4)), [9] * 4
    r_old, r_hot = _take(refs, free, 1), _take(refs, free, 1)
    trie.insert(old, r_old)
    trie.insert(hot, r_hot)
    refs[r_old[0]] -= 1  # both rows released: the trie's references only
    refs[r_hot[0]] -= 1
    trie.match(hot + [1])  # touch hot (a 5-token context matches a page)
    log.append((trie.evictable(), trie.evict(1), trie.owns(r_old[0]),
                trie.owns(r_hot[0]), r_old[0] in free))


def _pinned(pc, refs, free, log):
    trie = pc.PrefixCache(4, refs, free)
    row = _take(refs, free, 1)  # the row still holds it
    trie.insert(list(range(4)), row)
    log.append((refs[row[0]], trie.evict(1), trie.owns(row[0])))


def _parent_after_children(pc, refs, free, log):
    trie = pc.PrefixCache(4, refs, free)
    row = _take(refs, free, 2)
    trie.insert(list(range(8)), row)
    for p in row:
        refs[p] -= 1
    log.append((trie.evict(2), len(trie), sorted(free)))


def _clear(pc, refs, free, log):
    trie = pc.PrefixCache(4, refs, free)
    trie.insert(list(range(4)), _take(refs, free, 1))
    before = (list(refs), list(free))
    log.append((trie.clear(), len(trie), (list(refs), list(free)) == before))


def _random_ops(pc, refs, free, log):
    """Admissions of prompts over 3 templates (match, take references,
    insert), releases and evictions, as the engine drives the trie."""
    rng = np.random.RandomState(3)
    trie = pc.PrefixCache(4, refs, free)
    templates = [rng.randint(0, 5, (n,)) for n in (9, 13, 6)]
    rows = []
    for _ in range(80):
        roll = rng.rand()
        if roll < 0.5:
            t = templates[rng.randint(3)]
            ctx = list(np.concatenate([t, rng.randint(0, 5, (
                rng.randint(1, 6),))]))
            pages, tokens = trie.match(ctx)
            need = -(-len(ctx) // 4) - len(pages)
            if len(free) < need:
                trie.evict(need - len(free))
            if len(free) < need:
                log.append(("full", len(free)))
                continue
            for p in pages:
                refs[p] += 1
            row = pages + _take(refs, free, need)
            log.append(("admit", tokens, trie.insert(ctx, row)))
            rows.append(row)
        elif roll < 0.8 and rows:
            for p in rows.pop(rng.randint(len(rows))):
                refs[p] -= 1
                if refs[p] == 0:
                    free.append(p)
        else:
            log.append(("evict", trie.evict(int(rng.randint(1, 3)))))
        log.append((list(refs), list(free), sorted(trie.pages()),
                    trie.evictable()))


@pytest.mark.parametrize("case", [
    _roundtrip, _whole_prompt, _first_writer, _lru_leaf, _pinned,
    _parent_after_children, _clear, _random_ops], ids=lambda f: f.__name__)
def test_trie_operations_match_the_reference(case):
    n = 24 if case is _random_ops else 8
    logs = {}
    for name, pc in (("jax", jpc), ("torch", tpc)):
        refs, free = _pool(n)
        logs[name] = []
        case(pc, refs, free, logs[name])
        logs[name].append((refs, free))
        _invariant(refs, free, n)
    assert logs["torch"] == logs["jax"]


def test_trie_cases_give_the_reference_results():
    """The reference test's expected values, read off the port's logs."""
    def run(case):
        refs, free = _pool(8)
        log = []
        case(tpc, refs, free, log)
        return log, refs, free

    log, _, _ = run(_roundtrip)
    assert log[0] == 2 and log[1][0] == 2 and log[1][2][1] == 8
    assert run(_whole_prompt)[0][0][1] == 4
    log, _, _ = run(_first_writer)
    assert log[0] == (2, 0) and log[1][1] == 4
    assert run(_lru_leaf)[0][0] == (2, 1, False, True, True)
    assert run(_pinned)[0][0] == (2, 0, True)
    assert run(_parent_after_children)[0][0] == (2, 0, list(range(8)))
    assert run(_clear)[0][0] == (1, 0, True)


# ---------------------------------------------------------------------------
# the window writers and the window attention
# ---------------------------------------------------------------------------

N_PAGES = 12
TABLES = np.array([[3, 7, 0], [4, 5, 1], [6, 2, 8], [9, 10, 11]], np.int32)
START = np.array([5, 0, 14, 2], np.int32)
# row 0 overhangs its limit by 3, row 1 writes its whole window, row 2 is
# inactive, row 3 writes 2 of its 6
LIMIT = np.array([8, 6, 20, 4], np.int32)
ACTIVE = np.array([True, True, False, True])


def _window(seed, s=6, d=8):
    rng = np.random.RandomState(seed)
    return (rng.randn(4, s, KV_HEADS, d).astype(np.float32),
            rng.randn(4, s, KV_HEADS, d).astype(np.float32))


@pytest.mark.parametrize("scratch", [False, True])
@pytest.mark.parametrize("limits", ["limit", "none"])
@pytest.mark.parametrize("quant", [False, True])
def test_window_writers_match_the_reference(quant, limits, scratch):
    """Equal pools. With a scratch page the port's pools carry one more
    page, where the masked positions land; the rest equals the
    reference's, which drops them."""
    k_seq, v_seq = _window(1)
    d = k_seq.shape[-1]
    limit = LIMIT if limits == "limit" else None
    extra = 1 if scratch else 0
    jk, jv = jpa.alloc_pages(N_PAGES, PAGE, KV_HEADS, d,
                             jnp.int8 if quant else jnp.float32)
    tk, tv = tpa.alloc_pages(N_PAGES + extra, PAGE, KV_HEADS, d,
                             torch.int8 if quant else torch.float32)
    args = (jnp.asarray(TABLES), jnp.asarray(START))
    targs = (torch.from_numpy(TABLES), torch.from_numpy(START))
    jkw = dict(limit_lens=None if limit is None else jnp.asarray(limit),
               active=jnp.asarray(ACTIVE))
    tkw = dict(limit_lens=None if limit is None else torch.from_numpy(limit),
               active=torch.from_numpy(ACTIVE),
               scratch_page=N_PAGES if scratch else None)
    if quant:
        jks, jvs = jpa.alloc_page_scales(N_PAGES, PAGE, KV_HEADS)
        tks, tvs = tpa.alloc_page_scales(N_PAGES + extra, PAGE, KV_HEADS)
        want = jpa.scatter_paged_kv_window_q8(
            jk, jks, jv, jvs, jnp.asarray(k_seq), jnp.asarray(v_seq), *args,
            **jkw)
        want = (want[0], want[1][..., :PAGE], want[2], want[3][..., :PAGE])
        got = tpa.scatter_paged_kv_window_q8(
            tk, tks, tv, tvs, torch.from_numpy(k_seq),
            torch.from_numpy(v_seq), *targs, **tkw)
    else:
        want = jpa.scatter_paged_kv_window(
            jk, jv, jnp.asarray(k_seq), jnp.asarray(v_seq), *args, **jkw)
        got = tpa.scatter_paged_kv_window(
            tk, tv, torch.from_numpy(k_seq), torch.from_numpy(v_seq),
            *targs, **tkw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy()[:, :N_PAGES], np.asarray(w))
    # what was written: rows 0, 1 and 3 up to their limits, never row 2
    written = (got[0].numpy()[:, :N_PAGES] != 0).any(axis=(0, 3))
    n_valid = (LIMIT - START)[ACTIVE].sum() if limit is not None \
        else 6 * ACTIVE.sum()
    assert written.sum() == n_valid
    assert not written[[6, 2, 8]].any()


def _paged_inputs(seed, quant, d=8, q_heads=4):
    """Random pools, and a window's queries, for the four rows above."""
    rng = np.random.RandomState(seed)
    shape = (KV_HEADS, N_PAGES, PAGE, d)
    if quant:
        kp = rng.randint(-127, 128, shape).astype(np.int8)
        vp = rng.randint(-127, 128, shape).astype(np.int8)
        ks = rng.uniform(0.001, 0.02, shape[:3]).astype(np.float32)
        vs = rng.uniform(0.001, 0.02, shape[:3]).astype(np.float32)
    else:
        kp = rng.randn(*shape).astype(np.float32)
        vp = rng.randn(*shape).astype(np.float32)
        ks = vs = None
    q = rng.randn(4, 6, q_heads, d).astype(np.float32)
    return q, kp, vp, ks, vs


def _lane_pad(scales):
    """The reference's [kvh, n_pages, 128] scale pool around the port's."""
    out = np.zeros(scales.shape[:2] + (128,), np.float32)
    out[..., :scales.shape[2]] = scales
    return out


@pytest.mark.parametrize("active", [False, True])
@pytest.mark.parametrize("quant", [False, True])
def test_window_attention_matches_the_reference(quant, active):
    """Within 1e-5 (f32); the port gives an inactive row 0, so only the
    active rows are compared."""
    q, kp, vp, ks, vs = _paged_inputs(2, quant)
    jkw, tkw = {}, {}
    if quant:
        jkw = dict(k_scales=jnp.asarray(_lane_pad(ks)),
                   v_scales=jnp.asarray(_lane_pad(vs)))
        tkw = dict(k_scales=torch.from_numpy(ks),
                   v_scales=torch.from_numpy(vs))
    want = np.asarray(jpa.paged_attention_window_xla(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(TABLES), jnp.asarray(START), **jkw))
    got = tpa.paged_attention_window(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(TABLES), torch.from_numpy(START),
        active=torch.from_numpy(ACTIVE) if active else None, **tkw).numpy()
    rows = ACTIVE if active else np.ones(4, bool)
    np.testing.assert_allclose(got[rows], want[rows], rtol=0, atol=1e-5)
    assert not got[~rows].any()


@pytest.mark.parametrize("s", [1, 6])
@pytest.mark.parametrize("quant", [False, True])
def test_window_step_matches_the_reference(quant, s):
    """The model's paged step over random pages, ragged starts and an
    inactive row: at s = 6 a window that overhangs its limit, at s = 1 a
    row at its limit (it writes nothing); the active rows' logits within
    1e-4, the pools within 1e-5 (int8: exact, but for a value that rounds
    the other way, within one step)."""
    jm, tm, cfg = tiny_pair(seed=3)
    d = cfg.hidden_size // cfg.num_attention_heads
    rng = np.random.RandomState(3)
    ids = rng.randint(0, cfg.vocab_size, (4, 6)).astype(np.int64)[:, :s]
    limit = LIMIT if s > 1 else np.array([5, 1, 15, 3], np.int32)
    pools = [_paged_inputs(10 + li, quant, d=d)[1:]
             for li in range(cfg.num_hidden_layers)]
    if quant:
        jcaches = [tuple(jnp.asarray(a) for a in
                         (kp, vp, _lane_pad(ks), _lane_pad(vs)))
                   for kp, vp, ks, vs in pools]
        tcaches = [tuple(torch.from_numpy(a.copy()) for a in
                         (kp, vp, ks, vs)) for kp, vp, ks, vs in pools]
    else:
        jcaches = [(jnp.asarray(kp), jnp.asarray(vp))
                   for kp, vp, _, _ in pools]
        tcaches = [(torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy()))
                   for kp, vp, _, _ in pools]
    jl, jnew = jm.forward_paged(
        Tensor(jnp.asarray(ids)), jcaches, jnp.asarray(TABLES),
        jnp.asarray(START), active=jnp.asarray(ACTIVE),
        limit_lens=jnp.asarray(limit))
    with torch.no_grad():
        tl, tnew = tm.forward_paged(
            torch.from_numpy(ids), tcaches, torch.from_numpy(TABLES),
            torch.from_numpy(START), active=torch.from_numpy(ACTIVE),
            limit_lens=torch.from_numpy(limit))
    np.testing.assert_allclose(tl.numpy()[ACTIVE],
                               np.asarray(as_array(jl))[ACTIVE], rtol=0,
                               atol=1e-4)
    for jc, tc in zip(jnew, tnew):
        for j, t in zip(jc, tc):
            w = np.asarray(as_array(j))
            if w.shape != tuple(t.shape):  # the reference's lane pad
                w = w[..., :PAGE]
            np.testing.assert_allclose(t.numpy().astype(np.float32),
                                       w.astype(np.float32), rtol=0,
                                       atol=1 if t.dtype == torch.int8
                                       else 1e-5)


# ---------------------------------------------------------------------------
# the engine against the live JAX engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pair():
    return serving_pair()


def _engine_invariant(eng, outside=()):
    """held + free == n, no free page with a reference, and a page in two
    live rows is owned by the trie (the reference test's
    `_engine_invariant`); and the exact form, which also sees a leaked
    reference: each page's count is the rows that hold it, plus one if the
    trie owns it, plus one if a holder `outside` the engine has it."""
    n = len(eng._page_refs)
    free = eng._free_pages
    assert sorted(free) == sorted(set(free)), "duplicate free page"
    held = sum(1 for r in eng._page_refs if r > 0)
    assert held + len(free) == n, f"held {held} + free {len(free)} != {n}"
    assert all(eng._page_refs[p] == 0 for p in free)
    assert eng._scratch not in free and eng._scratch >= n
    owners = {}
    for si, s in enumerate(eng.slots):
        if not s.active:
            continue
        for p in eng.block_tables[si, :s.n_pages].tolist():
            owners.setdefault(p, []).append(si)
    for p, rows in owners.items():
        if len(rows) > 1:
            assert eng._prefix_cache is not None and \
                eng._prefix_cache.owns(p), \
                f"page {p} in slots {rows} without a trie entry"
    trie = eng._prefix_cache
    for p in range(n):
        assert eng._page_refs[p] == len(owners.get(p, ())) + int(
            trie is not None and trie.owns(p)) + int(p in outside), p


def _prompts(shared_len=24, tails=(3, 7, 5)):
    rng = np.random.RandomState(5)
    shared = rng.randint(0, VOCAB, (shared_len,))
    return [np.concatenate([shared, rng.randint(0, VOCAB, (t,))])
            for t in tails]


def _seq_run(eng, prompts, budgets, check=False):
    """One request at a time, so that later admissions see the trie."""
    outs = []
    for p, b in zip(prompts, budgets):
        rid = eng.add_request(p, max_new_tokens=b)
        fin = {f.request_id: f.output_ids.tolist() for f in eng.run()}
        outs.append(fin[rid])
        if check:
            _engine_invariant(eng)
    return outs


SEQ_CASES = {
    "cache_sequential_hits": dict(prefix_cache=1),
    "cache_chunk8": dict(prefix_cache=1, prefill_chunk=8),
    "chunk16_only": dict(prefill_chunk=16),
    "int8_kv_cache_chunk8": dict(prefix_cache=1, prefill_chunk=8,
                                 kv_cache_quant="int8"),
}


@pytest.mark.parametrize("case", sorted(SEQ_CASES))
def test_sequential_streams_equal_the_jax_engine(pair, case):
    jm, tm = pair
    ekw = dict(KW, **SEQ_CASES[case])
    prompts, budgets = _prompts(), [8, 6, 7]
    want = _seq_run(JaxEngine(jm, **ekw), prompts, budgets)
    eng = ServingEngine(tm, device="cpu", **ekw)
    assert _seq_run(eng, prompts, budgets, check=True) == want
    if eng._prefix_cache is not None:
        # the shared 24 tokens (3 pages) hit for requests 2 and 3
        assert eng._prefix_hits_total == 48
        assert eng._prefix_misses_total == sum(map(len, prompts)) - 48
    else:
        assert eng._prefix_hits_total == 0
    if eng.prefill_chunk:
        assert eng.chunk_rounds > 0 and eng.prefills == 0
    else:
        assert eng.chunk_rounds == 2  # the two hits' continuations


def _together(eng, prompts, budgets):
    rids = [eng.add_request(p, max_new_tokens=b)
            for p, b in zip(prompts, budgets)]
    fin = {f.request_id: f.output_ids.tolist() for f in eng.run()}
    return [fin[r] for r in rids]


def _withhold(eng, n):
    """Take n pages out of the pool for good, with a reference each (a
    holder outside the engine). Returns the pages."""
    pages = [eng._free_pages.pop(0) for _ in range(n)]
    for p in pages:
        eng._page_refs[p] += 1
    return pages


def test_preemption_pressure_streams_equal_the_jax_engine(pair):
    """The reference's case (8 pages, three concurrent requests that grow)
    with 3 pages withheld from both engines, so that the pool runs dry:
    admission reclaims trie pages and preemption decrefs."""
    jm, tm = pair
    kw = dict(KW, max_seq_len=32, prefix_cache=1)
    prompts, budgets = _prompts(10, (2, 4, 3)), [12, 10, 11]
    jeng = JaxEngine(jm, **kw)
    _withhold(jeng, 3)
    want = _together(jeng, prompts, budgets)
    eng = ServingEngine(tm, device="cpu", **kw)
    outside = _withhold(eng, 3)
    assert _together(eng, prompts, budgets) == want
    assert eng.preemptions > 0 and eng._prefix_hits_total > 0
    _engine_invariant(eng, outside)


def _churn(eng, steps=60):
    """The reference's randomized churn (admit, abort, evict) without its
    `_begin_recovery` step; the invariant after every step. Returns the
    finished streams by request id."""
    rng = np.random.RandomState(123)
    templates = [rng.randint(0, VOCAB, (n,)) for n in (18, 25)]
    live, done = [], {}
    for _ in range(steps):
        roll = rng.rand()
        if roll < 0.45 and len(live) < 6:
            t = templates[rng.randint(len(templates))]
            tail = rng.randint(0, VOCAB, (rng.randint(1, 5),))
            live.append(eng.add_request(
                np.concatenate([t, tail]),
                max_new_tokens=int(rng.randint(1, 8))))
        elif roll < 0.55 and live:
            eng.abort(live.pop(rng.randint(len(live))))
        elif roll < 0.62:
            eng._prefix_cache.evict(1)
        for f in eng.step():
            done[f.request_id] = f.output_ids.tolist()
            if f.request_id in live:
                live.remove(f.request_id)
        if isinstance(eng, ServingEngine):
            _engine_invariant(eng)
    for f in eng.run():
        done[f.request_id] = f.output_ids.tolist()
    return done


def test_randomized_churn_equals_the_jax_engine(pair):
    jm, tm = pair
    kw = dict(KW, max_seq_len=48, prefix_cache=1, prefill_chunk=8)
    want = _churn(JaxEngine(jm, **kw))
    eng = ServingEngine(tm, device="cpu", **kw)
    assert _churn(eng) == want and len(want) > 5
    _engine_invariant(eng)
    assert not any(s.active for s in eng.slots)
    # drained: only the trie's references remain, one a page
    assert sum(eng._page_refs) == len(eng._prefix_cache)
    assert sum(eng._page_refs) + len(eng._free_pages) == \
        len(eng._page_refs)


def _preempt_shared(eng):
    """Two rows share trie pages; preempting one must leave the survivor's
    shared pages off the free list. Returns (streams, shared pages)."""
    p1, p2 = _prompts(24, (3, 5))[:2]
    r1 = eng.add_request(p1, max_new_tokens=16)
    eng.step()  # admits r1, its first token; the trie holds its prompt
    r2 = eng.add_request(p2, max_new_tokens=16)
    eng.step()  # admits r2 on the trie's pages
    rows = {i: eng.block_tables[i, :s.n_pages].tolist()
            for i, s in enumerate(eng.slots) if s.active}
    (i1, row1), (i2, row2) = sorted(rows.items())
    shared = set(row1) & set(row2)
    victim = i2 if eng.slots[i2].request_id != r1 else i1
    survivor = i1 if victim == i2 else i2
    eng._preempt(victim)
    if isinstance(eng, ServingEngine):
        _engine_invariant(eng)
        surv = set(eng.block_tables[
            survivor, :eng.slots[survivor].n_pages].tolist())
        assert not (surv & set(eng._free_pages)), \
            "a live row's page landed on the free list"
    fin = {f.request_id: f.output_ids.tolist() for f in eng.run()}
    return [fin[r1], fin[r2]], shared


def test_decref_aware_preemption_equals_the_jax_engine(pair):
    jm, tm = pair
    kw = dict(KW, prefix_cache=1)
    want, _ = _preempt_shared(JaxEngine(jm, **kw))
    eng = ServingEngine(tm, device="cpu", **kw)
    got, shared = _preempt_shared(eng)
    assert shared, "prefix sharing never happened"
    assert got == want
    _engine_invariant(eng)


def test_admit_pending_runs_the_chunk_rounds_to_their_end(pair):
    """`admit_pending` prefills without decoding, the chunk rounds of a
    long prompt included; the stream then equals the JAX engine's."""
    jm, tm = pair
    kw = dict(KW, prefix_cache=1, prefill_chunk=8)
    p = _prompts(30, (2,))[0]
    want = _seq_run(JaxEngine(jm, **kw), [p], [6])
    eng = ServingEngine(tm, device="cpu", **kw)
    rid = eng.add_request(p, max_new_tokens=6)
    eng.admit_pending()
    s = next(s for s in eng.slots if s.active)
    assert not s.prefilling and s.needs_first_sample
    assert s._pf_n_chunks == eng.chunk_rounds == 4  # 32 tokens / 8
    assert eng.decode_steps == 0
    fin = {f.request_id: f.output_ids.tolist() for f in eng.run()}
    assert [fin[rid]] == want


def test_async_waits_for_chunked_prefill(pair):
    """The async pipeline runs only when no row is prefilling; the streams
    of a burst engine with async_depth equal the JAX engine's."""
    jm, tm = pair
    kw = dict(KW, prefix_cache=1, prefill_chunk=8, decode_burst=4)
    prompts, budgets = _prompts(24, (3, 9)), [9, 12]
    want = _together(JaxEngine(jm, async_depth=2, **kw), prompts, budgets)
    eng = ServingEngine(tm, device="cpu", async_depth=2, **kw)
    for p, b in zip(prompts, budgets):
        eng.add_request(p, max_new_tokens=b)
    eng._admit()
    assert any(s.prefilling for s in eng.slots)
    assert not eng._async_ok()
    fin = {f.request_id: f.output_ids.tolist() for f in eng.run()}
    assert [fin[0], fin[1]] == want


def test_flags_and_chunk_alignment_as_the_reference(pair):
    jm, tm = pair
    saved = get_flags(["FLAGS_prefix_cache", "FLAGS_prefill_chunk"])
    set_flags({"FLAGS_prefix_cache": 1, "FLAGS_prefill_chunk": 12})
    try:
        eng = ServingEngine(tm, device="cpu", **KW)
        assert eng.prefix_cache_enabled and eng.prefill_chunk == 16
        assert not ServingEngine(tm, device="cpu", prefix_cache=0,
                                 prefill_chunk=0, **KW).prefix_cache_enabled
    finally:
        set_flags(saved)
    j = JaxEngine(jm, prefix_cache=1, prefill_chunk=12, **KW)
    t = ServingEngine(tm, device="cpu", prefix_cache=1, prefill_chunk=12,
                      **KW)
    assert (t.prefill_chunk, t.prefix_cache_enabled) == \
        (j.prefill_chunk, j.prefix_cache_enabled)


def test_draft_model_with_the_prefix_cache_raises_as_the_reference(pair):
    jm, tm = pair
    kw = dict(KW, spec_decode=2)
    for draft in ("prefix_cache", "prefill_chunk"):
        extra = {draft: 1 if draft == "prefix_cache" else 8}
        with pytest.raises(ValueError, match="draft_model"):
            JaxEngine(jm, draft_model=jm, **kw, **extra)
        with pytest.raises(ValueError, match="draft_model"):
            ServingEngine(tm, draft_model=tm, device="cpu", **kw, **extra)


class _FitEngine:
    """A test double: a short free list and trie pages to reclaim."""
    page_size = 8

    def __init__(self, free, evictable):
        self._free_pages = list(range(free))
        self._evictable = evictable
        self._pending = [(0, np.zeros((30,), np.int64), 4, [])]  # 4 pages

    def _avail_pages(self):
        return len(self._free_pages) + self._evictable


@pytest.mark.parametrize("free,evictable", [(2, 2), (2, 1), (4, 0), (0, 4)])
def test_admission_counts_evictable_pages_as_the_reference(free, evictable):
    eng = _FitEngine(free, evictable)
    want = jsched.FifoSchedulerPolicy().select_admission(eng)
    assert tsched.FifoSchedulerPolicy().select_admission(eng) == want
    assert (want == 0) == (free + evictable >= 4)
