"""The rank programs of the port's tensor-parallel tests
(`tests/test_torch_mp_layers.py`, `test_torch_sequence_parallel.py`,
`test_torch_fleet.py`, `test_torch_tensor_parallel.py`,
`test_torch_serving_tp.py`, `test_torch_quant_tp.py`), run over gloo on
the CPU by `torch_dist_workers.run_group`. They import torch and the port
only. Every input, weight and upstream gradient comes from the test as a
full numpy array; a rank takes its shard, and returns its shards of the
results as numpy arrays, which the tests join and hold against the JAX
package's layers under a tp mesh."""
from __future__ import annotations

import numpy as np
import torch

from torch_dist_workers import _save

# the layer cases' widths: a column linear IN -> OUT, a row linear
# IN2 -> OUT2, an embedding of VOCAB rows of HID, logits over VOCAB
IN, OUT, IN2, OUT2, VOCAB, HID = 8, 6, 6, 8, 10, 4
TOKENS = (2, 5)
IGNORE = -100


def _fleet_init(dp=1, tp=1, device="cpu"):
    """init_parallel_env on the CPU, then fleet.init at these degrees;
    returns (fleet, hcg)."""
    import paddle_tpu_torch.distributed as D
    from paddle_tpu_torch.distributed import fleet

    D.init_parallel_env(device=device, timeout=60)
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = dict(dp_degree=dp, mp_degree=tp)
    fleet.init(is_collective=True, strategy=strategy)
    return fleet, fleet.get_hybrid_communicate_group()


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


def _n(t):
    return None if t is None else t.detach().numpy().copy()


def _shard(a, r, tp, axis):
    return np.split(np.asarray(a), tp, axis=axis)[r]


def _load(layer, **tensors):
    with torch.no_grad():
        for name, a in tensors.items():
            getattr(layer, name).copy_(torch.from_numpy(np.asarray(a)))


def _finish(out_dir, rank, res):
    import paddle_tpu_torch.distributed as D

    D.destroy_process_group()
    _save(out_dir, rank, res)


def layer_results(c, r, tp):
    """Each mp_layer at this rank's shard of `c`'s weights: outputs and
    gradients (this rank's shards)."""
    from paddle_tpu_torch.distributed.fleet.layers.mpu import (
        ColumnParallelLinear, ParallelCrossEntropy, RowParallelLinear,
        VocabParallelEmbedding)
    from paddle_tpu_torch.distributed.fleet.layers.mpu.mp_layers import \
        is_distributed

    res = {}
    for gather in (True, False):
        lin = ColumnParallelLinear(IN, OUT, has_bias=True,
                                   gather_output=gather, device="cpu")
        _load(lin, weight=_shard(c["w"], r, tp, 1),
              bias=_shard(c["b"], r, tp, 0))
        x = _t(c["x"], True)
        y = lin(x)
        g = c["g"] if gather else _shard(c["g"], r, tp, -1)
        (y * _t(g)).sum().backward()
        res[f"column_gather_{gather}"] = dict(
            y=_n(y), dx=_n(x.grad), dw=_n(lin.weight.grad),
            db=_n(lin.bias.grad),
            distributed=(is_distributed(lin.weight),
                         is_distributed(lin.bias)))
    for parallel in (True, False):
        lin = RowParallelLinear(IN2, OUT2, has_bias=True,
                                input_is_parallel=parallel, device="cpu")
        _load(lin, weight=_shard(c["w2"], r, tp, 0), bias=c["b2"])
        x = _t(_shard(c["x2"], r, tp, -1) if parallel else c["x2"], True)
        y = lin(x)
        (y * _t(c["g2"])).sum().backward()
        res[f"row_parallel_{parallel}"] = dict(
            y=_n(y), dx=_n(x.grad), dw=_n(lin.weight.grad),
            db=_n(lin.bias.grad),
            distributed=(is_distributed(lin.weight),
                         is_distributed(lin.bias)))
    emb = VocabParallelEmbedding(VOCAB, HID, device="cpu")
    _load(emb, weight=_shard(c["e"], r, tp, 0))
    y = emb(torch.from_numpy(c["ids"]))
    (y * _t(c["ge"])).sum().backward()
    res["embedding"] = dict(y=_n(y), dw=_n(emb.weight.grad))
    logits = _t(_shard(c["logits"], r, tp, -1), True)
    loss = ParallelCrossEntropy(ignore_index=IGNORE)(
        logits, torch.from_numpy(c["labels"]))
    (loss * _t(c["gl"])).sum().backward()
    res["cross_entropy"] = dict(loss=_n(loss), dlogits=_n(logits.grad))
    return res


def rng_results(seed, r):
    """The tracker's streams as `model_parallel_random_seed` seeds them on
    tensor-parallel rank r, and a dropout mask drawn from each."""
    from paddle_tpu_torch.distributed.fleet.layers.mpu import random as mpr
    from paddle_tpu_torch.framework import random as R

    mpr.model_parallel_random_seed(seed, r)
    tracker = mpr.get_rng_state_tracker()
    out = {"seeds": {n: g.initial_seed() for n, g in tracker.states_.items()}}
    for name in ("global_seed", "local_seed"):
        with tracker.rng_state(name):
            out[name] = [R.next_seed() for _ in range(3)]
        out[name + "_mask"] = _n(mpr.dropout(torch.ones(64), p=0.5,
                                             rng_name=name))
    saved = tracker.get_states_tracker()
    with tracker.rng_state("local_seed"):
        first = R.next_seed()
    tracker.set_states_tracker(saved)
    with tracker.rng_state("local_seed"):
        out["replayed"] = (first, R.next_seed())
    return out


def clip_results(state, batch, r):
    """HybridParallelClipGrad's global norm over a tiny GPT at this
    degree, built from the full `state`, as the clip computes it for its
    scale (`_params_norm`); and the same with the planted fault that takes
    every parameter for a shard (summing every square over "tp", so
    counting the replicated gradients tp times)."""
    from paddle_tpu_torch.distributed.fleet.meta_parallel import \
        HybridParallelClipGrad
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.weights import load_gpt_state

    class EverySquareSummed(HybridParallelClipGrad):
        @staticmethod
        def _sharded(p):
            return True

    model = GPTForCausalLM(GPTConfig.tiny(), device="cpu")
    load_gpt_state(model, state)
    x = torch.from_numpy(batch)
    model.compute_loss(model(x), x).backward()
    pg = [(p, p.grad) for p in model.parameters()]
    return {key: float(cls(ClipGradByGlobalNorm(1.0))._params_norm(pg))
            for key, cls in (("norm", HybridParallelClipGrad),
                             ("all_summed", EverySquareSummed))}


# the models a seed builds at tp 2 (`seeded_results`): family, tied head
SEEDED = [("llama", False), ("llama", True), ("gpt", True), ("gpt", False)]


def seeded_model(family, tie, seed, device="cpu"):
    """Tiny LLaMA or GPT built from `seed` (its own `init_weights`) at the
    global mesh's tensor-parallel degree."""
    from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                         LlamaForCausalLM)
    from paddle_tpu_torch.models.llama import LlamaConfig

    if family == "llama":
        cfg, cls = LlamaConfig.tiny(**TINY_LLAMA), LlamaForCausalLM
    else:
        cfg, cls = GPTConfig.tiny(**TINY_GPT), GPTForCausalLM
    cfg.tie_word_embeddings = tie
    return cls(cfg, device=device, seed=seed)


def seeded_results(seed):
    """This rank's shards of each `SEEDED` model built from `seed`."""
    from paddle_tpu_torch import weights as W

    return {f"{fam}_{tie}": (W.llama_state_to_numpy if fam == "llama"
                             else W.gpt_state_to_numpy)(
                                 seeded_model(fam, tie, seed))
            for fam, tie in SEEDED}


def mp_layers_main(out_dir, case, gpt_state, batch, seed):
    _, hcg = _fleet_init(tp=2)
    r = hcg.get_model_parallel_rank()
    res = dict(layers=layer_results(case, r, 2), rng=rng_results(seed, r),
               clip=clip_results(gpt_state, batch, r),
               seeded=seeded_results(seed), tp_rank=r)
    _finish(out_dir, r, res)


def sp_results(c, r, tp):
    """The sequence-parallel pair on this rank's sequence shard: a column
    SP linear, gelu, a row SP linear with a bias, then an RMSNorm whose
    weight is marked sequence-parallel, under the all_reduce hooks."""
    import torch.nn.functional as TF

    from paddle_tpu_torch.distributed.fleet import utils as U
    from paddle_tpu_torch.nn import RMSNorm

    col = U.ColumnSequenceParallelLinear(IN, OUT, has_bias=True,
                                         device="cpu")
    row = U.RowSequenceParallelLinear(OUT, IN, has_bias=True, device="cpu")
    norm = RMSNorm(IN, device="cpu")
    U.mark_as_sequence_parallel_parameter(norm.weight)
    _load(col, weight=_shard(c["w"], r, tp, 1), bias=_shard(c["b"], r, tp, 0))
    _load(row, weight=_shard(c["w2"], r, tp, 0), bias=c["b2"])
    _load(norm, weight=c["wn"])
    holder = torch.nn.ModuleList([col, row, norm])
    U.register_sequence_parallel_allreduce_hooks(holder)
    U.register_sequence_parallel_allreduce_hooks(holder)  # hooked once
    x = _t(_shard(c["x"], r, tp, 1), True)
    z = norm(row(TF.gelu(col(x), approximate="tanh")))
    (z * _t(_shard(c["g"], r, tp, 1))).sum().backward()
    ops = {}
    a = _t(c["x"])
    ops["scatter"] = _n(U.ScatterOp.apply(a, axis=1))
    ops["gather"] = _n(U.GatherOp.apply(_t(_shard(c["x"], r, tp, 1)),
                                        axis=1))
    ops["all_gather"] = _n(U.AllGatherOp.apply(_t(_shard(c["x"], r, tp, 1)),
                                               axis=1))
    ops["reduce_scatter"] = _n(U.ReduceScatterOp.apply(a, axis=1))
    return dict(z=_n(z), dx=_n(x.grad), dw=_n(col.weight.grad),
                db=_n(col.bias.grad), dw2=_n(row.weight.grad),
                db2=_n(row.bias.grad), dwn=_n(norm.weight.grad), ops=ops,
                marked=(row.bias.sequence_parallel,
                        norm.weight.sequence_parallel))


def sp_main(out_dir, case):
    _, hcg = _fleet_init(tp=2)
    r = hcg.get_model_parallel_rank()
    _finish(out_dir, r, dict(sp=sp_results(case, r, 2), tp_rank=r))


def _train_step_refusal():
    """What building a tiny LLaMA and its train step over the global mesh
    raises (None when both build)."""
    from paddle_tpu_torch.models import build_train_step
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW

    try:
        model = LlamaForCausalLM(LlamaConfig.tiny(**TINY_LLAMA), device="cpu")
        build_train_step(model, AdamW(learning_rate=0.1,
                                      parameters=model.parameters()))
    except NotImplementedError as e:
        return str(e)
    return None


def _step_grad(fleet, rank):
    """A parameter's gradient (rank + 1 on each rank) after the
    distributed optimizer's `step` (SGD at lr 0)."""
    from paddle_tpu_torch.optimizer import SGD

    p = torch.nn.Parameter(torch.zeros(3))
    p.grad = torch.full((3,), float(rank + 1))
    try:
        fleet.distributed_optimizer(SGD(learning_rate=0.0,
                                        parameters=[p])).step()
    except NotImplementedError as e:
        return "raises: " + str(e)
    return _n(p.grad)


def fleet_main(out_dir, files):
    """fleet.init at each strategy of a world of 2, and what
    distributed_model / distributed_optimizer return; the worker API."""
    import paddle_tpu_torch.distributed as D
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.optimizer import AdamW

    D.init_parallel_env(device="cpu", timeout=60)
    res = dict(rank=fleet.worker_index(), num=fleet.worker_num(),
               first=fleet.is_first_worker(),
               shard=fleet.util.get_file_shard(files),
               reduced=fleet.util.all_reduce(np.array([1.0, 2.0]) *
                                             (1 + D.get_rank())),
               endpoints=len(fleet.worker_endpoints()))
    fleet.barrier_worker()
    net = torch.nn.Linear(4, 4)
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

    for name, degrees in (("dp", dict(dp_degree=2)),
                          ("tp", dict(mp_degree=2)),
                          ("pp", dict(pp_degree=2)),
                          ("sharding", dict(sharding_degree=2)),
                          ("sep", dict(sep_degree=2))):
        s = fleet.DistributedStrategy()
        s.hybrid_configs = dict(s.hybrid_configs, **degrees)
        s.gradient_merge = True
        s.gradient_merge_configs = {"k_steps": 3, "avg": False}
        fleet.init(is_collective=True, strategy=s)
        hcg = fleet.get_hybrid_communicate_group()
        got = dict(mesh=tuple(D.get_mesh().mesh_dim_names),
                   mode=hcg.get_parallel_mode(),
                   sizes=(hcg.get_data_parallel_world_size(),
                          hcg.get_model_parallel_world_size()))
        # at pp 2 the model is a LLaMA built under the mesh (its stage)
        model = LlamaForCausalLM(LlamaConfig.tiny(**TINY_LLAMA),
                                 device="cpu") if name == "pp" else net
        for what, fn in (
                ("model", lambda: type(fleet.distributed_model(model))
                 .__name__),
                ("optimizer", lambda: fleet.distributed_optimizer(
                    AdamW(learning_rate=0.1, parameters=net.parameters())))):
            try:
                out = fn()
                got[what] = out if isinstance(out, str) else (
                    type(out).__name__, out._gradient_merge_k,
                    out._gradient_merge_avg)
            except NotImplementedError as e:
                got[what] = "raises: " + str(e)
        got["train_step"] = _train_step_refusal()
        got["step_grad"] = _step_grad(fleet, D.get_rank())
        res[name] = got
    # fleet.save / load_model: one checkpoint of a replicated layer (its
    # weight written once, by rank 0), read back into another
    import os

    from paddle_tpu_torch.nn import Linear

    src, dst = Linear(4, 3), Linear(4, 3)
    with torch.no_grad():
        src.weight.copy_(torch.arange(12.0).reshape(4, 3))
        dst.weight.zero_()
    path = os.path.join(out_dir, "fleet_ckpt")
    fleet.fleet.save(path, src)
    fleet.fleet.load_model(path, dst)
    res["checkpoint"] = dict(equal=bool(torch.equal(src.weight, dst.weight)),
                             files=sorted(os.listdir(path)))
    D.destroy_process_group()
    _save(out_dir, res["rank"], res)


def tp_train(family, dp, tp, state, x, y, steps, chunks, lr, sp=False):
    """`family` ("llama" or "gpt") through fleet.init, distributed_model,
    distributed_optimizer (AdamW at `lr`, or SGD at lr 0 for the loss
    alone) and build_train_step at dp x tp (LLaMA with sequence
    parallelism at `sp`), from the full numpy `state`; each rank steps on
    its dp shard of (x, y). Returns the losses and this rank's parameter
    shards."""
    from paddle_tpu_torch import weights as W
    from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                         build_train_step)
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.optimizer import SGD, AdamW

    fleet, hcg = _fleet_init(dp=dp, tp=tp)
    if family == "llama":
        cfg = LlamaConfig.tiny(**TINY_LLAMA)
        load, to_numpy = W.load_llama_state, W.llama_state_to_numpy
        cls = LlamaForCausalLM
    else:
        cfg = GPTConfig.tiny(**TINY_GPT)
        load, to_numpy = W.load_gpt_state, W.gpt_state_to_numpy
        cls = GPTForCausalLM
    cfg.fused_ce_chunks = chunks
    if sp:
        cfg.sequence_parallel = True
    model = load(cls(cfg, device="cpu"), state)
    dm = fleet.distributed_model(model)
    inner = AdamW(learning_rate=lr, parameters=dm.parameters()) if lr \
        else SGD(learning_rate=0.0, parameters=dm.parameters())
    opt = fleet.distributed_optimizer(inner)
    import paddle_tpu_torch.distributed as D

    step = build_train_step(dm, opt, mesh=D.get_mesh())
    d = hcg.get_data_parallel_rank()
    n = x.shape[0] // dp
    xs = torch.from_numpy(x[d * n:(d + 1) * n])
    ys = torch.from_numpy(y[d * n:(d + 1) * n])
    losses = [step(xs, ys).item() for _ in range(steps)]
    marked = sorted(n for n, p in model.named_parameters()
                    if getattr(p, "sequence_parallel", False))
    state = {n: np.array(a) for n, a in to_numpy(model).items()}
    out = dict(losses=losses, state=state, dp_rank=d,
               tp_rank=hcg.get_model_parallel_rank(),
               wrapper=type(dm).__name__, optimizer=type(opt).__name__,
               sequence_parallel=marked)
    if dp > 1:
        out["eager_grads"] = eager_step_grads(family, model, dm, opt, xs, ys)
    return out


# a replicated and a column-split parameter of each family
EAGER_PROBES = {
    "llama": ("llama.norm.weight", "llama.layers.0.mlp.up_proj.weight"),
    "gpt": ("gpt.ln_f.weight", "gpt.layers.0.mlp.fc_in.weight"),
}


def eager_step_grads(family, model, dm, opt, xs, ys):
    """An eager step (backward on the rank's dp shard, then the wrapper's
    `step`): {name: (the probe's gradient before step, after it)}."""
    opt.clear_grad()
    model.compute_loss(dm(xs), ys).backward()
    params = dict(model.named_parameters())
    before = {n: _n(params[n].grad) for n in EAGER_PROBES[family]}
    opt.step()
    return {n: (before[n], _n(params[n].grad)) for n in before}


# the reference's tp-mesh test geometry (tests/test_gpt.py::_make,
# tests/test_fused_ce.py): tiny widths, batch 4 x 16
TINY_GPT = dict(vocab=128, hidden=32, layers=2, heads=2, seq=32)
TINY_LLAMA = dict(vocab=128, hidden=32, layers=2, heads=4, seq=32)


def tp_generate(family, tp, state, prompt, n_new):
    """`generate` (greedy) of `family` at tensor-parallel degree `tp` from
    the full numpy `state`: (tokens, scores) as numpy."""
    from paddle_tpu_torch import weights as W
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

    _fleet_init(tp=tp)
    if family == "llama":
        model = W.load_llama_state(LlamaForCausalLM(
            LlamaConfig.tiny(**TINY_LLAMA), device="cpu"), state)
    else:
        model = W.load_gpt_state(GPTForCausalLM(
            GPTConfig.tiny(**TINY_GPT), device="cpu"), state)
    model.eval()
    tokens, scores = model.generate(torch.from_numpy(prompt),
                                    max_new_tokens=n_new)
    return dict(tokens=_n(tokens), scores=_n(scores))


def train_runs_main(out_dir, runs):
    """For each (tag, function name, args) of `runs` in one group, one
    after another (fleet.init builds each run's mesh), the function's
    result: `tp_train`'s or `tp_generate`'s; each rank saves {tag:
    result}."""
    import paddle_tpu_torch.distributed as D

    fns = {"train": tp_train, "generate": tp_generate}
    out = {tag: fns[fn](*args) for tag, fn, args in runs}
    rank = D.get_rank()
    D.destroy_process_group()
    _save(out_dir, rank, out)


# ---------------------------------------------------------------------------
# tensor-parallel serving (`tests/test_torch_serving_tp.py`)
# ---------------------------------------------------------------------------


def serving_model(family, cfg, state):
    """A tiny LLaMA or GPT (`cfg`: its config's fields) built under the
    global mesh, so it holds this rank's shards, and loaded from the full
    numpy `state`."""
    from paddle_tpu_torch import weights as W
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

    if family == "llama":
        return W.load_llama_state(
            LlamaForCausalLM(LlamaConfig(**cfg), device="cpu"), state)
    return W.load_gpt_state(GPTForCausalLM(GPTConfig(**cfg), device="cpu"),
                            state)


def serve_case(c):
    """One configuration of `c` (a dict: the model's family, config and
    full state, the quantization, a draft model, the engine's arguments,
    pages withheld from the pool, warmup, and `phases`: lists of (prompt,
    max_new_tokens, add_request kwargs), each queued and then run dry) on
    this rank's engine. Returns the streams in request order, the gathered
    logits of the first sampled position (after warmup), the pools'
    shapes and the engine's counters."""
    from paddle_tpu_torch.inference import ServingEngine
    from paddle_tpu_torch.nn.quant import (WeightOnlyLinear,
                                           quantize_for_inference)

    model = serving_model(c["family"], c["cfg"], c["state"])
    if c.get("quant"):
        quantize_for_inference(model, *c["quant"], exclude=("lm_head",))
    draft = serving_model(c["family"], c["draft_cfg"], c["draft_state"]) \
        if c.get("draft_cfg") else None
    eng = ServingEngine(model, device="cpu", draft_model=draft,
                        **c["engine"])
    if c.get("withhold"):
        del eng._free_pages[-c["withhold"]:]
    if c.get("warmup"):
        eng.warmup(sampling=True)
    logits = []
    sample = eng._sample

    def recording(last, *args):
        if not logits:
            logits.append(_n(last))
        return sample(last, *args)

    eng._sample = recording
    rids, streams = [], {}
    for phase in c["phases"]:
        for prompt, n, kw in phase:
            rids.append(eng.add_request(prompt, max_new_tokens=n, **kw))
        for f in eng.run():
            streams[f.request_id] = f.output_ids.tolist()
    return dict(
        streams=[streams[r] for r in rids], first_logits=logits[0],
        pools=tuple(eng.k_pages[0].shape),
        scales=None if eng.k_scales is None else tuple(eng.k_scales[0].shape),
        draft_pools=None if eng._draft_caches is None
        else tuple(eng._draft_caches[0][0].shape),
        counters=dict(prefills=eng.prefills, chunk_rounds=eng.chunk_rounds,
                      decode_steps=eng.decode_steps,
                      spec_rounds=eng.spec_rounds,
                      preemptions=eng.preemptions,
                      prefix_hits=eng._prefix_hits_total,
                      graph_captures=eng.graph_captures,
                      free_pages=len(eng._free_pages)),
        quantized=sum(isinstance(m, WeightOnlyLinear)
                      and m._shard is not None for m in model.modules()),
        graphs=(eng._graphs, eng._spec_graphs), tp=eng.tp)


def serving_refusals(cfg):
    """What the engine raises under the tp mesh for a model built at tp 1
    with `cfg` (the messages), with the mesh handed in and with the global
    one."""
    from paddle_tpu_torch.distributed import mesh as M
    from paddle_tpu_torch.inference import ServingEngine
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

    mesh = M.get_mesh()
    out = {}
    for tag, kvh in (("kv_heads", 1), ("built_at_tp1", cfg[
            "num_key_value_heads"])):
        M.set_mesh(None)
        try:
            model = LlamaForCausalLM(LlamaConfig(**dict(
                cfg, num_key_value_heads=kvh)), device="cpu")
        finally:
            M.set_mesh(mesh)
        try:
            ServingEngine(model, device="cpu", max_seq_len=cfg[
                "max_position_embeddings"], page_size=8,
                mesh=mesh if tag == "kv_heads" else None)
            out[tag] = None
        except ValueError as e:
            out[tag] = str(e)
    return out


def serving_runs_main(out_dir, cases, refusal_cfg):
    """Each case of `cases` (`serve_case`) on this rank, under fleet.init
    at the case's mp_degree (dp_degree: the rest of the world); then the
    engine's refusals at tp 2. Each rank saves {tag: result}."""
    import paddle_tpu_torch.distributed as D

    torch.set_num_threads(1)
    D.init_parallel_env(device="cpu", timeout=60)
    world = D.get_world_size()
    out, tp = {}, None
    for c in sorted(cases, key=lambda c: c["tp"]):
        if c["tp"] != tp:
            tp = c["tp"]
            _, hcg = _fleet_init(dp=world // tp, tp=tp)
        out[c["tag"]] = serve_case(c)
        out[c["tag"]].update(tp_rank=hcg.get_model_parallel_rank(),
                             dp_rank=hcg.get_data_parallel_rank())
    _fleet_init(dp=world // 2, tp=2)
    out["refusals"] = serving_refusals(refusal_cfg)
    rank = D.get_rank()
    D.destroy_process_group()
    _save(out_dir, rank, out)


# ---------------------------------------------------------------------------
# quantized tensor-parallel linears (`tests/test_torch_quant_tp.py`)
# ---------------------------------------------------------------------------


def quant_layers(c, r, tp):
    """For each (algo, group_size) of `c["schemes"]`: a ColumnParallelLinear
    (no gather) into a RowParallelLinear (`input_is_parallel`), both with
    biases, from this rank's shards of `c`'s full weights, quantized
    (`quantize_for_inference`, as a Sequential); their quantized weights
    and scales and the pair's output on `c["x"]`. Then what quantizing a
    row shard whose rows split a group (or, int4, a byte) raises, and what
    the rank's column output is with `gather_output`."""
    from paddle_tpu_torch.distributed.fleet.layers.mpu import (
        ColumnParallelLinear, RowParallelLinear)
    from paddle_tpu_torch.nn.quant import WeightOnlyLinear
    from paddle_tpu_torch.nn.quant import quantize_for_inference

    k1, n1 = c["w"].shape
    n2 = c["w2"].shape[1]
    res = {}
    for algo, gs in c["schemes"]:
        col = ColumnParallelLinear(k1, n1, has_bias=True,
                                   gather_output=False, device="cpu")
        row = RowParallelLinear(n1, n2, has_bias=True,
                                input_is_parallel=True, device="cpu")
        _load(col, weight=_shard(c["w"], r, tp, 1),
              bias=_shard(c["b"], r, tp, 0))
        _load(row, weight=_shard(c["w2"], r, tp, 0), bias=c["b2"])
        m = quantize_for_inference(torch.nn.Sequential(col, row), algo,
                                   group_size=gs)
        with torch.no_grad():
            y = m(torch.from_numpy(c["x"]))
        res[f"{algo}_{gs}"] = dict(
            y=_n(y), types=[type(x).__name__ for x in m],
            col=(_n(m[0].quant_weight), _n(m[0].weight_scale)),
            row=(_n(m[1].quant_weight), _n(m[1].weight_scale)))
    raised = {}
    for name, (k, algo, gs) in c["straddle"].items():
        lin = RowParallelLinear(k, 128, has_bias=False,
                                input_is_parallel=True, device="cpu")
        try:
            WeightOnlyLinear.from_source(lin, algo, gs)
            raised[name] = None
        except ValueError as e:
            raised[name] = str(e)
    res["straddle"] = raised
    col = ColumnParallelLinear(k1, n1, has_bias=True, gather_output=True,
                               device="cpu")
    _load(col, weight=_shard(c["w"], r, tp, 1), bias=_shard(c["b"], r, tp, 0))
    with torch.no_grad():
        res["gathered"] = _n(WeightOnlyLinear.from_source(col)(
            torch.from_numpy(c["x"])))
    return res


def quant_model(state, cfg):
    """A tiny LLaMA at the mesh's degree from the full `state`, quantized
    int8 per channel (lm_head kept): each quantized linear's weight and
    scales."""
    from paddle_tpu_torch.nn.quant import (WeightOnlyLinear,
                                           quantize_for_inference)

    model = quantize_for_inference(serving_model("llama", cfg, state),
                                   exclude=("lm_head",))
    return {n: (_n(m.quant_weight), _n(m.weight_scale), m._shard[0])
            for n, m in model.named_modules()
            if isinstance(m, WeightOnlyLinear)}


def quant_main(out_dir, case, state, cfg):
    _, hcg = _fleet_init(tp=2)
    r = hcg.get_model_parallel_rank()
    _finish(out_dir, r, dict(layers=quant_layers(case, r, 2),
                             model=quant_model(state, cfg), tp_rank=r))


# ---------------------------------------------------------------------------
# the card test of tensor-parallel serving (`tests/test_torch_cuda.py -k
# tp_serving`): gloo ranks over CUDA tensors on one card
# ---------------------------------------------------------------------------

# a 2-layer f32 LLaMA at head_dim 128 (the paged decode kernel's), one head
# a rank at tp 2
CARD_LLAMA = dict(vocab_size=256, hidden_size=256, intermediate_size=512,
                  num_hidden_layers=2, num_attention_heads=2,
                  num_key_value_heads=2, max_position_embeddings=128)
CARD_ENGINE = dict(max_batch=3, max_seq_len=128, page_size=16,
                   decode_burst=4)


def card_streams(model, dev, prompts, n_new):
    """Greedy streams of CARD_ENGINE's engine over `prompts`, in request
    order, and the paged decode kernel's launches while it served."""
    from paddle_tpu_torch.inference import ServingEngine
    from paddle_tpu_torch.kernels import paged_attention as kpa

    eng = ServingEngine(model, device=dev, **CARD_ENGINE)
    n0 = kpa.launches
    rids = [eng.add_request(p, max_new_tokens=n_new) for p in prompts]
    done = {f.request_id: f.output_ids.tolist() for f in eng.run()}
    return [done[r] for r in rids], kpa.launches - n0, eng.decode_steps


def card_serving_main(out_dir, state, prompts, n_new):
    """One rank on the card (gloo, named by PADDLE_DISTRI_BACKEND): the
    CARD_LLAMA model at tp 2 from the full `state`, served by
    `card_streams`."""
    import paddle_tpu_torch.distributed as D
    from paddle_tpu_torch import weights as W
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

    _, hcg = _fleet_init(tp=2, device=None)
    dev = D.env.device()
    model = W.load_llama_state(
        LlamaForCausalLM(LlamaConfig(**CARD_LLAMA), device=dev), state)
    streams, launches, steps = card_streams(model, dev, prompts, n_new)
    _finish(out_dir, hcg.get_model_parallel_rank(), dict(
        streams=streams, launches=launches, decode_steps=steps,
        device=str(dev), backend=D.get_backend(),
        q_proj=tuple(model.llama.layers[0].self_attn.q_proj.weight.shape)))
