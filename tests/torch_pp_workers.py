"""The rank programs of the port's pipeline tests
(`tests/test_torch_pipeline.py`, `tests/test_torch_pp_layers.py`), run over
gloo on the CPU by `torch_dist_workers.run_group`. They import torch and
the port only. The weights come from the tests as the reference model's
full numpy state; every pp rank of one dp coordinate takes the same rows
(its dp shard of the batch) and returns its readings as numpy arrays and
Python numbers."""
from __future__ import annotations

import os

import numpy as np
import torch

from torch_dist_workers import _save

# the reference's own geometry (tests/test_pipeline.py:17-21), at `layers`
TINY = dict(vocab=64, hidden=32, heads=2, seq=16)
GPT_TINY = dict(vocab=64, hidden=32, heads=2, seq=16)
LR = 1e-3

_DEGREES = []


def _fleet(pp=1, dp=1, tp=1, accumulate=1, mode="1F1B", sharding=1):
    """fleet.init over CPU ranks at these degrees (once while they stay the
    same: each init makes every group anew); the strategy's pipeline
    configs set each call. (fleet, hcg)."""
    import paddle_tpu_torch.distributed as D
    from paddle_tpu_torch.distributed import fleet

    torch.set_num_threads(1)
    D.init_parallel_env(device="cpu", timeout=60)
    if _DEGREES != [(pp, dp, tp, sharding)]:
        s = fleet.DistributedStrategy()
        s.hybrid_configs = dict(dp_degree=dp, mp_degree=tp, pp_degree=pp,
                                sharding_degree=sharding)
        fleet.init(is_collective=True, strategy=s)
        _DEGREES[:] = [(pp, dp, tp, sharding)]
    fleet.fleet._strategy.pipeline_configs = dict(
        accumulate_steps=accumulate, micro_batch_size=1, schedule_mode=mode)
    return fleet, fleet.get_hybrid_communicate_group()


def _config(family, layers, v=1):
    from paddle_tpu_torch.models import GPTConfig
    from paddle_tpu_torch.models.llama import LlamaConfig

    if family == "llama":
        cfg = LlamaConfig.tiny(layers=layers, **TINY)
    else:
        cfg = GPTConfig.tiny(layers=layers, **GPT_TINY)
    cfg.virtual_pp_degree = v
    return cfg


def _model(family, layers, state=None, v=1, seed=0):
    from paddle_tpu_torch import weights as W
    from paddle_tpu_torch.models import GPTForCausalLM
    from paddle_tpu_torch.models.llama import LlamaForCausalLM

    cls = LlamaForCausalLM if family == "llama" else GPTForCausalLM
    model = cls(_config(family, layers, v), device="cpu", seed=seed)
    if state is not None:
        load = W.load_llama_state if family == "llama" else W.load_gpt_state
        load(model, state)
    return model


def _to_numpy(model, family):
    from paddle_tpu_torch import weights as W

    fn = W.llama_state_to_numpy if family == "llama" else W.gpt_state_to_numpy
    return {k: (np.array(v) if isinstance(v, np.ndarray) else v)
            for k, v in fn(model).items()}


def _moments(model, opt):
    """{name: first moment} of this rank's parameters."""
    inner = getattr(opt, "_inner_opt", opt)
    pos = {id(p): i for i, p in enumerate(inner._parameter_list)}
    out = {}
    for n, p in model.named_parameters():
        st = inner._accumulators.get(pos[id(p)])
        if st is not None:
            out[n] = st["moment1"].detach().float().numpy().copy()
    return out


def _rows(a, hcg):
    """This rank's dp shard of the batch."""
    n, d = hcg.get_data_parallel_world_size(), hcg.get_data_parallel_rank()
    k = a.shape[0] // n
    return torch.from_numpy(a[d * k:(d + 1) * k])


def pp_train(state, x, y, steps, family="llama", layers=4, pp=2, dp=1, tp=1,
             schedule="1f1b", v=1, M=4, how="step"):
    """`steps` steps of LLaMA / GPT at pp x dp x tp: `how` "step" through
    `build_train_step` (AdamW), "fleet" through `distributed_model` /
    `distributed_optimizer` and `PipelineParallel.train_batch` (M
    accumulate steps). Returns the losses, this rank's state and first
    moments, its stage, and the most microbatches in flight on it."""
    from paddle_tpu_torch.models import build_train_step
    from paddle_tpu_torch.optimizer import AdamW

    mode = {"1f1b": "1F1B", "gpipe": "FThenB", "vpp": "VPP"}[schedule]
    fleet, hcg = _fleet(pp, dp, tp, accumulate=M, mode=mode)
    model = _model(family, layers, state, v)
    xs, ys = _rows(x, hcg), _rows(y, hcg)
    losses, trace = [], []
    if how == "gsp":
        # sharded first (stage 3 slices the parameters at once), then the
        # step: the shared weights' slices are broadcast
        _, opt, _ = group_sharded_parallel(
            model, opt, {2: "os_g", 3: "p_g_os"}[stage])
        step = build_train_step(model, opt, num_microbatches=M,
                                pipeline_schedule=schedule,
                                virtual_pp_degree=v)
        run = lambda: step(xs, ys)  # noqa: E731
        zero = step._zero
        kind = (step._schedule, zero.axis)
    elif how == "fleet":
        dm = fleet.distributed_model(model)
        opt = fleet.distributed_optimizer(
            AdamW(learning_rate=LR, parameters=model.parameters()))
        for _ in range(steps):
            losses.append(float(dm.train_batch((xs, ys), opt)))
        kind = (type(dm).__name__, type(opt).__name__)
    else:
        opt = AdamW(learning_rate=LR, parameters=model.parameters())
        step = build_train_step(model, opt, num_microbatches=M,
                                pipeline_schedule=schedule,
                                virtual_pp_degree=v)
        step.trace = trace
        for _ in range(steps):
            losses.append(float(step(xs, ys)))
        kind = (step._schedule, step._link.stats())
    return dict(losses=losses, state=_to_numpy(model, family),
                moments=_moments(model, opt), stage=hcg.get_stage_id(),
                in_flight=max((t[3] for t in trace), default=None),
                kind=kind)


def grads_by_schedule(state, x, y, M=8):
    """One SGD(lr 1) step at pp 2 under "gpipe" and "1f1b" from the same
    weights: each parameter's update (its gradient), and the most
    microbatches in flight on this rank under each."""
    from paddle_tpu_torch.models import build_train_step
    from paddle_tpu_torch.optimizer import SGD

    _, hcg = _fleet(pp=2)
    out = {}
    for sched in ("gpipe", "1f1b"):
        model = _model("llama", 4, state)
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        step = build_train_step(model, SGD(learning_rate=1.0,
                                           parameters=model.parameters()),
                                num_microbatches=M, pipeline_schedule=sched)
        step.trace = []
        step(_rows(x, hcg), _rows(y, hcg))
        out[sched] = dict(
            grads={n: (before[n] - p.detach()).numpy()
                   for n, p in model.named_parameters()},
            in_flight=max(t[3] for t in step.trace))
    out["stage"] = hcg.get_stage_id()
    return out


def pipeline_info(pp=2, dp=1, tp=1):
    """The HybridCommunicateGroup's pipeline accessors on this rank."""
    import paddle_tpu_torch.distributed as D

    _, hcg = _fleet(pp, dp, tp)
    return dict(rank=D.get_rank(), stage=hcg.get_stage_id(),
                first=hcg.is_first_stage, last=hcg.is_last_stage,
                next=hcg._get_p2p_next_rank(), prev=hcg._get_p2p_prev_rank(),
                ranks=hcg.get_pipe_parallel_ranks(),
                dp_rank=hcg.get_data_parallel_rank(),
                tp_rank=hcg.get_model_parallel_rank())


def seeded(family, layers, seed, pp=2, dp=1, tp=1, v=1, tie=None):
    """The state of a model built from its own seed on this rank."""
    _fleet(pp, dp, tp)
    from paddle_tpu_torch.models import GPTForCausalLM
    from paddle_tpu_torch.models.llama import LlamaForCausalLM

    cfg = _config(family, layers, v)
    if tie is not None:
        cfg.tie_word_embeddings = tie
    cls = LlamaForCausalLM if family == "llama" else GPTForCausalLM
    return _to_numpy(cls(cfg, device="cpu", seed=seed), family)


def _raises(fn):
    try:
        fn()
    except (NotImplementedError, ValueError) as e:
        return f"{type(e).__name__}: {e}"
    return None


def refusals(state, x, y):
    """What the pipeline step refuses at pp 2, each message."""
    from paddle_tpu_torch.models import build_train_step
    from paddle_tpu_torch.optimizer import AdamW

    _, hcg = _fleet(pp=2)

    def build(**kw):
        model = _model("llama", 4, state)
        return build_train_step(model, AdamW(
            learning_rate=LR, parameters=model.parameters()), **kw)

    def odd_batch():
        build(pipeline_schedule="vpp", virtual_pp_degree=2)

    def odd_vpp_batch():
        model = _model("llama", 4, state, v=2)
        step = build_train_step(model, AdamW(
            learning_rate=LR, parameters=model.parameters()),
            pipeline_schedule="vpp", virtual_pp_degree=2)
        step(_rows(x, hcg)[:3], _rows(y, hcg)[:3])

    def m_not_multiple():
        model = _model("llama", 4, state, v=2)
        step = build_train_step(model, AdamW(
            learning_rate=LR, parameters=model.parameters()),
            num_microbatches=3, pipeline_schedule="vpp", virtual_pp_degree=2)
        step(_rows(x, hcg)[:6], _rows(y, hcg)[:6])

    return dict(
        merge=_raises(lambda: build(gradient_merge_steps=2)),
        layout=_raises(odd_batch),
        unknown=_raises(lambda: build(pipeline_schedule="zb")),
        vpp_no_m=_raises(odd_vpp_batch),
        vpp_m=_raises(m_not_multiple),
        layers=_raises(lambda: _model("llama", 3)),
        forward=_raises(lambda: _model("llama", 4)(_rows(x, hcg))),
        generate=_raises(lambda: _model("llama", 4).generate(
            _rows(x, hcg)[:1], max_new_tokens=1)))


def zero_refusal(state, x, y):
    """ZeRO stage 2 with pp 2 x dp 2 (once refused): one step's loss, the
    engine's stage and axis, or the error it raised."""
    from paddle_tpu_torch.models import build_train_step
    from paddle_tpu_torch.optimizer import AdamW

    _, hcg = _fleet(pp=2, dp=2)
    model = _model("llama", 4, state)
    try:
        step = build_train_step(model, AdamW(
            learning_rate=LR, parameters=model.parameters()),
            sharding_stage=2)
        loss = float(step(_rows(x, hcg), _rows(y, hcg)))
    except (NotImplementedError, ValueError) as e:
        return f"{type(e).__name__}: {e}"
    return dict(loss=loss, stage=step._zero.stage, axis=step._zero.axis)


# ---------------------------------------------------------------------------
# ZeRO under the pipeline (`tests/test_torch_pp_sharding.py`)
# ---------------------------------------------------------------------------


def _data_rows(a, hcg, sharding):
    """This rank's shard of the batch over dp x sharding (every pp and tp
    rank of one coordinate the same rows)."""
    n = hcg.get_data_parallel_world_size() * sharding
    d = hcg.get_data_parallel_rank() * sharding + \
        hcg.get_sharding_parallel_rank()
    k = a.shape[0] // n
    return torch.from_numpy(a[d * k:(d + 1) * k])


def zero_pp_train(state, x, y, steps, family="llama", layers=4, pp=2,
                  sharding=2, dp=1, tp=1, schedule="1f1b", v=1, M=4,
                  stage=2, how="step"):
    """`steps` steps at pp x sharding (x dp, x tp) with ZeRO `stage`: `how`
    "step" through `build_train_step(..., sharding_stage=stage)` on a
    plain AdamW, "jit" through `jit.train_step`, "fleet" through
    `fleet.distributed_model` (PipelineParallel) and
    `fleet.distributed_optimizer` (a DygraphShardingOptimizer at stage 1;
    `group_sharded_parallel` at stages 2-3) and `train_batch`, "gsp"
    through `group_sharded_parallel` first, then `build_train_step`.
    Returns the
    losses, this rank's state (stage-3 pieces), the reduce_scatters and
    buckets of its engine, the updates a step and the launch counts."""
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.distributed import get_mesh
    from paddle_tpu_torch.distributed.fleet.meta_parallel.sharding import \
        group_sharded_parallel
    from paddle_tpu_torch.models import build_train_step
    from paddle_tpu_torch.optimizer import AdamW

    mode = {"1f1b": "1F1B", "gpipe": "FThenB", "vpp": "VPP"}[schedule]
    fleet, hcg = _fleet(pp, dp, tp, accumulate=M, mode=mode,
                        sharding=sharding)
    model = _model(family, layers, state, v)
    xs, ys = _data_rows(x, hcg, sharding), _data_rows(y, hcg, sharding)
    opt = AdamW(learning_rate=LR, parameters=model.parameters())
    losses, updates = [], []
    if how == "gsp":
        # sharded first (stage 3 slices the parameters at once), then the
        # step: the shared weights' slices are broadcast
        _, opt, _ = group_sharded_parallel(
            model, opt, {2: "os_g", 3: "p_g_os"}[stage])
        step = build_train_step(model, opt, num_microbatches=M,
                                pipeline_schedule=schedule,
                                virtual_pp_degree=v)
        run = lambda: step(xs, ys)  # noqa: E731
        zero = step._zero
        kind = (step._schedule, zero.axis)
    elif how == "fleet":
        dm = fleet.distributed_model(model)
        if stage == 1:
            sopt = fleet.distributed_optimizer(opt)
        else:
            _, sopt, _ = group_sharded_parallel(
                model, opt, {2: "os_g", 3: "p_g_os"}[stage])
        run = lambda: dm.train_batch((xs, ys), sopt)  # noqa: E731
        zero = sopt._zero_engine
        kind = (type(dm).__name__, type(sopt).__name__)
    else:
        if how == "jit":
            step = jit.train_step(model, model.compute_loss, opt,
                                  sharding_stage=stage, mesh=get_mesh())
        else:
            step = build_train_step(model, opt, num_microbatches=M,
                                    pipeline_schedule=schedule,
                                    virtual_pp_degree=v,
                                    sharding_stage=stage)
        run = lambda: step(xs, ys)  # noqa: E731
        zero = step._zero
        kind = (step._schedule, zero.axis if zero is not None else None)
    rs = []
    for _ in range(steps):
        before = getattr(opt, "_zero_test_updates", 0)
        rs0 = zero.traffic["reduce_scatter"] if zero is not None else 0
        losses.append(float(run()))
        updates.append(getattr(opt, "_zero_test_updates", 0) - before)
        rs.append((zero.traffic["reduce_scatter"] if zero is not None
                   else 0) - rs0)
    return dict(losses=losses, state=_to_numpy(model, family),
                stage=hcg.get_stage_id(), kind=kind,
                zero_stage=None if zero is None else zero.stage,
                buckets=None if zero is None else len(zero.buckets),
                pieces=None if zero is None else sum(
                    len(b.pieces) for b in zero.buckets),
                reduce_scatters=rs, updates=updates)


def _moment_pieces(model, opt):
    """{name: (lo, hi, first moment)}: this rank's ZeRO pieces of each
    parameter's first moment (its flattened elements lo..hi-1)."""
    from paddle_tpu_torch.distributed.fleet.meta_parallel.sharding \
        .group_sharded import engine_of

    inner = getattr(opt, "_inner_opt", opt)
    params = inner._parameter_list
    eng = engine_of(params)
    names = {id(p): n for n, p in model.named_parameters()}
    out = {}
    for i, st in inner._accumulators.items():
        lo, hi = eng.piece_range(params[i])
        out[names[id(params[i])]] = (lo, hi, st["moment1"].numpy().copy())
    return out


def ckpt_pp_run(state, x, y, ckpt_dir, stage=2, schedule="1f1b", M=4,
                steps=2):
    """pp 2 x sharding 2 at ZeRO `stage`: one step, then the state saved
    twice (`fleet.save` to ckpt_dir/fleet, and `CheckpointManager.save`
    of step 1 to ckpt_dir/run with the trainer snapshot), then the
    uninterrupted run's next steps; then fresh models, optimizers and
    engines restored (by `CheckpointManager.restore` and by
    `fleet.load_model`) take the same steps. Returns the losses and
    states of each, the state and first-moment pieces after step 1."""
    import paddle_tpu_torch.distributed as D
    from paddle_tpu_torch.distributed import checkpoint as ck
    from paddle_tpu_torch.models import build_train_step
    from paddle_tpu_torch.optimizer import AdamW

    fleet, hcg = _fleet(2, 1, 1, accumulate=M, sharding=2)
    xs, ys = _data_rows(x, hcg, 2), _data_rows(y, hcg, 2)

    def fresh():
        model = _model("llama", 4, state)
        opt = AdamW(learning_rate=LR, parameters=model.parameters())
        step = build_train_step(model, opt, num_microbatches=M,
                                pipeline_schedule=schedule,
                                sharding_stage=stage)
        return model, opt, step

    model, opt, step = fresh()
    first = float(step(xs, ys))
    after1 = _to_numpy(model, "llama")
    moments1 = _moment_pieces(model, opt)
    fleet.fleet.save(os.path.join(ckpt_dir, "fleet"), model, opt)
    mgr = ck.CheckpointManager(os.path.join(ckpt_dir, "run"))
    mgr.save(1, ck._model_state(model, opt),
             trainer_state=ck.trainer_state_snapshot(1))
    mgr.wait()
    full = [float(step(xs, ys)) for _ in range(steps - 1)]
    out = dict(first=first, after1=after1, moments1=moments1,
               full=full, full_state=_to_numpy(model, "llama"),
               stage=hcg.get_stage_id(),
               sharding_rank=hcg.get_sharding_parallel_rank())
    # a fresh run restored by the manager
    model, opt, step = fresh()
    ck._init_optimizer_state(model, opt)
    restored = mgr.restore(template=ck._model_state(model, opt))
    ck._apply_model_state(model, opt, restored)
    snap = mgr.restore_trainer_state()
    out["resumed"] = [float(step(xs, ys)) for _ in range(steps - 1)]
    out["resumed_state"] = _to_numpy(model, "llama")
    out["trainer_step"] = snap["step"]
    out["counts"] = dict(mgr.counts)
    # and one restored by fleet.load_model
    model, opt, step = fresh()
    fleet.fleet.load_model(os.path.join(ckpt_dir, "fleet"), model, opt)
    out["loaded"] = [float(step(xs, ys)) for _ in range(steps - 1)]
    out["loaded_state"] = _to_numpy(model, "llama")
    # load_state_dict's mesh and spec_fn: this rank's rows (over
    # "sharding") of two saved weights, against the whole ones
    path = os.path.join(ckpt_dir, "fleet")
    whole = ck.load_state_dict(path)["model"]
    names = ("llama.embed_tokens.weight", "llama.norm.weight")
    got = ck.load_state_dict(
        path, template={"model": {n: whole[n] for n in names}},
        mesh=D.get_mesh(), spec_fn=lambda n, a: ("sharding", None)
        if a.dim() == 2 else None)["model"]
    k = whole[names[0]].shape[0] // 2
    s = hcg.get_sharding_parallel_rank()
    out["spec_rows"] = bool(
        isinstance(got[names[0]], ck.LocalPiece)
        and torch.equal(got[names[0]].value, whole[names[0]][s * k:(s + 1) * k])
        and torch.equal(got[names[1]], whole[names[1]]))
    D.barrier()
    return out


def zero_pp_clip_and_inf(state, x, y, M=4, stage=2):
    """At pp 2 x sharding 2 through `PipelineParallel`: the global norm the
    clip of a `DygraphShardingOptimizer` (ClipGradByGlobalNorm) computes
    from the rank's slices, against the norm of stage 0's gradients (the
    whole gradients averaged over "sharding", `HybridParallelClipGrad`);
    then under a GradScaler an inf planted in the last stage's second
    sharding rank's slice: every rank skips and halves the scale."""
    import paddle_tpu_torch.distributed as D
    from paddle_tpu_torch.amp import GradScaler
    from paddle_tpu_torch.distributed.fleet.meta_parallel import \
        HybridParallelClipGrad
    from paddle_tpu_torch.distributed.fleet.meta_parallel.sharding import \
        group_sharded_parallel
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW

    fleet, hcg = _fleet(2, 1, 1, accumulate=M, sharding=2)
    xs, ys = _data_rows(x, hcg, 2), _data_rows(y, hcg, 2)
    # stage 0: whole gradients averaged over "sharding"
    model = _model("llama", 4, state)
    dm = fleet.distributed_model(model)
    dm.forward_backward_pipeline((xs, ys))
    for p in model.parameters():
        D.all_reduce(p.grad, op=D.ReduceOp.AVG, group="sharding")
    want = float(HybridParallelClipGrad(ClipGradByGlobalNorm(1.0))
                 ._params_norm([(p, p.grad) for p in model.parameters()]))
    # ZeRO `stage`: the norm from the slices
    model = _model("llama", 4, state)
    dm = fleet.distributed_model(model)
    opt = AdamW(learning_rate=LR, parameters=model.parameters(),
                grad_clip=ClipGradByGlobalNorm(1.0))
    _, sopt, _ = group_sharded_parallel(model, opt,
                                        {1: "os", 2: "os_g", 3: "p_g_os"}
                                        [stage])
    seen = []
    clip = sopt._clip(sopt._zero_engine)
    norm_of = clip._params_norm
    clip._params_norm = lambda pairs: seen.append(float(norm_of(pairs))) \
        or norm_of(pairs)
    dm.train_batch((xs, ys), sopt)
    # the GradScaler's skip
    before = {k: v.copy() for k, v in _to_numpy(model, "llama").items()
              if not k.startswith("@")}
    scaler = GradScaler(init_loss_scaling=1024.0)
    dm.forward_backward_pipeline((xs, ys), scaler)
    eng = sopt._zero_engine
    if hcg.get_stage_id() == 1 and hcg.get_sharding_parallel_rank() == 1:
        eng.buckets[0].grad[0] = float("inf")
    scaler.step(sopt)
    sopt.clear_grad()
    after = _to_numpy(model, "llama")
    skipped = all(np.array_equal(before[k], after[k]) for k in before)
    return dict(norm=seen[0] if seen else None, want=want, skipped=skipped,
                scale=scaler.get_loss_scaling(), stage=hcg.get_stage_id())


def generic_fwd(x, ws, pp):
    """`pipeline.spmd_pipeline` over "pp": tanh layers, this rank's block
    of `ws`."""
    from paddle_tpu_torch.distributed import pipeline as P

    _, hcg = _fleet(pp=pp)
    S, r = hcg.get_pipe_parallel_world_size(), hcg.get_stage_id()
    per = len(ws) // S
    local = torch.from_numpy(ws[r * per:(r + 1) * per])

    def stage_fn(w, h):
        for i in range(w.shape[0]):
            h = torch.tanh(h @ w[i])
        return h

    out = P.spmd_pipeline(stage_fn, local, P.microbatch(
        torch.from_numpy(x), 4))
    return out.numpy()


def generic_vpp(ws, head_w, xs, ys, v=2):
    """`pipeline.spmd_pipeline_vpp` at pp 4 x v 2 (the reference's
    `tests/test_vpp.py` geometry): (loss, this rank's chunk gradients,
    the head's, the inputs')."""
    from paddle_tpu_torch.distributed import pipeline as P

    _, hcg = _fleet(pp=4)
    S, r = 4, hcg.get_stage_id()
    local = torch.from_numpy(np.stack([ws[j * S + r][None]
                                       for j in range(v)]))

    def stage_fn(params, h):
        for w in params["W"]:
            h = torch.tanh(h @ w)
        return h

    def head_fn(hp, act, tgt):
        lp = torch.log_softmax(act @ hp["W"], dim=-1)
        return -lp.gather(-1, tgt[:, None]).mean()

    loss, d_sp, d_hp, d_x = P.spmd_pipeline_vpp(
        stage_fn, {"W": local}, torch.from_numpy(xs), head_fn,
        {"W": torch.from_numpy(head_w)}, torch.from_numpy(ys),
        num_chunks=v)
    return dict(loss=float(loss), d_sp=d_sp["W"].numpy(),
                d_hp=d_hp["W"].numpy(), d_x=d_x.numpy(), stage=r)


def generic_1f1b(ws, head_w, xs, ys):
    """`pipeline.spmd_pipeline_1f1b` at pp 4 on the VPP geometry's layers
    (two a stage, in order): (loss, this rank's gradients, the head's, the
    inputs')."""
    from paddle_tpu_torch.distributed import pipeline as P

    _, hcg = _fleet(pp=4)
    r = hcg.get_stage_id()
    per = len(ws) // 4

    def stage_fn(params, h):
        for w in params["W"]:
            h = torch.tanh(h @ w)
        return h

    def head_fn(hp, act, tgt):
        lp = torch.log_softmax(act @ hp["W"], dim=-1)
        return -lp.gather(-1, tgt[:, None]).mean()

    loss, d_sp, d_hp, d_x = P.spmd_pipeline_1f1b(
        stage_fn, {"W": torch.from_numpy(ws[r * per:(r + 1) * per])},
        torch.from_numpy(xs), head_fn, {"W": torch.from_numpy(head_w)},
        torch.from_numpy(ys))
    return dict(loss=float(loss), d_sp=d_sp["W"].numpy(),
                d_hp=d_hp["W"].numpy(), d_x=d_x.numpy(), stage=r)


def layer_train(weights, x, y, steps=2, M=4):
    """A `PipelineLayer` with a shared (tied) linear at pp 2 through
    fleet.distributed_model -> `PipelineParallel.train_batch` (SGD 0.1):
    the losses, each entry's weight this rank holds after the steps, and
    what the layer reports."""
    import torch.nn.functional as TF

    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        LayerDesc, PipelineLayer, SharedLayerDesc)
    from paddle_tpu_torch.nn import Linear
    from paddle_tpu_torch.optimizer import SGD

    fleet, hcg = _fleet(pp=2, accumulate=M)
    layer = PipelineLayer(layer_descs(LayerDesc, SharedLayerDesc, Linear),
                          num_stages=2, loss_fn=TF.cross_entropy)
    with torch.no_grad():
        for i, (mod, _) in zip(layer._held, layer.run_function):
            if i in weights:
                mod.weight.copy_(torch.from_numpy(weights[i]))
    dm = fleet.distributed_model(layer)
    opt = SGD(learning_rate=0.1, parameters=layer.parameters())
    xs, ys = torch.from_numpy(x), torch.from_numpy(y)
    losses = [float(dm.train_batch((xs, ys), opt)) for _ in range(steps)]
    # each weight under the first entry that holds it (a shared linear
    # under its first use)
    first = {}
    for i, d in enumerate(layer.descs):
        first.setdefault(getattr(d, "layer_name", i), i)
    held = {first[getattr(layer.descs[i], "layer_name", i)]:
            mod.weight.detach().numpy().copy()
            for i, (mod, _) in zip(layer._held, layer.run_function)
            if hasattr(mod, "weight")}
    ev = dm.eval_batch((xs, ys))
    outs = dm.eval_batch((xs, ys), compute_loss=False)
    return dict(losses=losses, held=held, stage=hcg.get_stage_id(),
                segments=layer._segments, eval=float(ev),
                outs=None if outs is None else outs.numpy(),
                by_stage=sorted(layer.parameters_by_stage),
                model=type(dm).__name__)


def layer_scaler_and_clip(weights, x, y, M=4):
    """The same `PipelineLayer` at pp 2: the hybrid clip's global norm of
    one schedule's gradients (every stage's squares, the shared weight
    counted once), then a GradScaler step with an inf planted in stage 1's
    gradient: both stages skip and halve the scale."""
    import torch.nn.functional as TF

    from paddle_tpu_torch.amp import GradScaler
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        HybridParallelClipGrad, LayerDesc, PipelineLayer, SharedLayerDesc)
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm, Linear
    from paddle_tpu_torch.optimizer import SGD

    fleet, hcg = _fleet(pp=2, accumulate=M)
    layer = PipelineLayer(layer_descs(LayerDesc, SharedLayerDesc, Linear),
                          num_stages=2, loss_fn=TF.cross_entropy)
    with torch.no_grad():
        for i, (mod, _) in zip(layer._held, layer.run_function):
            if i in weights:
                mod.weight.copy_(torch.from_numpy(weights[i]))
    dm = fleet.distributed_model(layer)
    data = (torch.from_numpy(x), torch.from_numpy(y))
    dm.forward_backward_pipeline(data)
    clip = HybridParallelClipGrad(ClipGradByGlobalNorm(1.0))
    norm = float(clip._params_norm([(p, p.grad)
                                    for p in layer.parameters()]))
    for p in layer.parameters():
        p.grad = None
    opt = fleet.distributed_optimizer(SGD(learning_rate=0.1,
                                          parameters=layer.parameters()))
    scaler = GradScaler(init_loss_scaling=1024.0)
    before = [p.detach().clone() for p in layer.parameters()]
    dm.forward_backward_pipeline(data, scaler)
    if hcg.get_stage_id() == 1:
        next(layer.parameters()).grad.view(-1)[0] = float("inf")
    scaler.step(opt)
    scaler.update()
    opt.clear_grad()
    skipped = all(torch.equal(a, p.detach())
                  for a, p in zip(before, layer.parameters()))
    return dict(norm=norm, skipped=skipped,
                scale=scaler.get_loss_scaling())


def _tied(layer, h):
    return h @ layer.weight.t()


def layer_descs(LayerDesc, SharedLayerDesc, Linear):
    """x [b, 8] -> tied linear -> tanh -> linear -> tanh -> linear -> tanh
    -> the tied linear transposed -> [b, 8] logits (the same list in the
    reference with its classes)."""
    return [SharedLayerDesc("tie", Linear, None, "weight", 8, 8),
            torch.tanh, LayerDesc(Linear, 8, 8), torch.tanh,
            LayerDesc(Linear, 8, 8), torch.tanh,
            SharedLayerDesc("tie", Linear, _tied, "weight", 8, 8)]


def generic_layer_values(layer):
    """{name: value} every weight of a `layer_descs` PipelineLayer takes
    (`weights.param_pieces`' names, drawn from a seed a desc; the shared
    linear's from desc 0's on both stages)."""
    from paddle_tpu_torch.weights import param_pieces

    out = {}
    for name in param_pieces(layer):
        i = int(name.split(".")[1])
        seed = 100 + (0 if i == len(layer.descs) - 1 else i)
        out[name] = (np.random.RandomState(seed).normal(size=(8, 8)) *
                     0.3).astype(np.float32)
    return out


def mp_net():
    """An embedding, a column- and a row-parallel linear of mp_layers
    (shards at tp > 1, whole layers at tp 1)."""
    from paddle_tpu_torch.distributed.fleet.layers.mpu.mp_layers import (
        ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding)

    net = torch.nn.Module()
    net.embed = VocabParallelEmbedding(16, 8)
    net.up = ColumnParallelLinear(8, 12, has_bias=True, gather_output=False)
    net.down = RowParallelLinear(12, 8, input_is_parallel=True)
    return net


# mp_net's whole tensors and the axis each shard splits
MP_SPLIT = {"embed.weight": 0, "up.weight": 1, "up.bias": 0,
            "down.weight": 0, "down.bias": None}


def mp_whole():
    rng = np.random.RandomState(7)
    shapes = {"embed.weight": (16, 8), "up.weight": (8, 12), "up.bias": (12,),
              "down.weight": (12, 8), "down.bias": (8,)}
    return {n: rng.normal(size=s).astype(np.float32)
            for n, s in shapes.items()}


def ckpt_generic(ckpt_dir, x, y, M=2):
    """fleet.save / load_model beyond LLaMA and GPT. At pp 2 x sharding 2:
    a `PipelineLayer` (`layer_descs`: a shared linear on both stages) after
    one AdamW step through `PipelineParallel.train_batch`, saved with its
    optimizer and loaded into a fresh layer and optimizer. At dp 2 x tp 2:
    `mp_net` holding its slices of `mp_whole`, saved and loaded into a
    zeroed one. Then the refusals: a name the ranks hold with different
    values, a shard without its split axis. Returns what each rank held
    under each name, whether the loads gave it back, and the errors."""
    import torch.nn.functional as TF

    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        LayerDesc, PipelineLayer, SharedLayerDesc)
    from paddle_tpu_torch.nn import Linear
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.weights import param_pieces, set_param_pieces

    fleet, hcg = _fleet(2, 1, 1, accumulate=M, sharding=2)

    def layer():
        return PipelineLayer(layer_descs(LayerDesc, SharedLayerDesc, Linear),
                             num_stages=2, loss_fn=TF.cross_entropy)

    def moments(model, opt):
        names = {id(p): n for n, p in model.named_parameters()}
        return {names[id(opt._parameter_list[i])]: st["moment1"].numpy()
                for i, st in opt._accumulators.items()}

    src = layer()
    set_param_pieces(src, {n: torch.from_numpy(v) for n, v in
                           generic_layer_values(src).items()})
    dm = fleet.distributed_model(src)
    opt = AdamW(learning_rate=LR, parameters=src.parameters())
    dm.train_batch((torch.from_numpy(x), torch.from_numpy(y)), opt)
    path = os.path.join(ckpt_dir, "layer")
    fleet.fleet.save(path, dm, opt)
    held = {n: v.numpy().copy() for n, (v, *_) in param_pieces(src).items()}
    dst = layer()
    dm2 = fleet.distributed_model(dst)
    opt2 = AdamW(learning_rate=LR, parameters=dst.parameters())
    fleet.fleet.load_model(path, dm2, opt2)
    got = {n: v.numpy() for n, (v, *_) in param_pieces(dst).items()}
    out = dict(stage=hcg.get_stage_id(), layer_held=held,
               layer_loaded=set(got) == set(held) and all(
                   np.array_equal(got[n], v) for n, v in held.items()),
               layer_moments=moments(src, opt) and all(
                   np.array_equal(moments(dst, opt2)[n], m)
                   for n, m in moments(src, opt).items())
               and opt2._step_count == opt._step_count == 1)
    # tensor parallelism through mp_layers
    fleet, hcg = _fleet(pp=1, dp=2, tp=2)
    rank = hcg.get_model_parallel_rank()
    net, whole = mp_net(), mp_whole()
    with torch.no_grad():
        for n, p in net.named_parameters():
            ax, a = MP_SPLIT[n], whole[n]
            if ax is not None:
                k = a.shape[ax] // 2
                a = np.take(a, range(rank * k, (rank + 1) * k), axis=ax)
            p.copy_(torch.from_numpy(a))
    path = os.path.join(ckpt_dir, "mp")
    fleet.fleet.save(path, net)
    back = mp_net()
    with torch.no_grad():
        for p in back.parameters():
            p.zero_()
    fleet.fleet.load_model(path, back)
    out["mp_loaded"] = all(torch.equal(a, b) for a, b in zip(
        net.parameters(), back.parameters()))
    # the refusals, raised alike on every rank
    errors = []
    odd = Linear(4, 3)
    with torch.no_grad():
        odd.weight.fill_(float(hcg.get_data_parallel_rank()))
    unplaced = Linear(4, 3)
    unplaced.weight.is_distributed = True
    for model in (odd, unplaced):
        try:
            fleet.fleet.save(os.path.join(ckpt_dir, "refused"), model)
            errors.append(None)
        except ValueError as e:
            errors.append(str(e))
    out["refusals"] = errors
    return out


def save_stage(state, out_dir, rank):
    """`paddle_tpu_torch.save` of a pp-2 model's state_dict: one file a
    rank; (its names, reloaded equal)."""
    import paddle_tpu_torch as ptt

    _fleet(pp=2)
    model = _model("llama", 4, state)
    path = os.path.join(out_dir, f"stage{rank}.pdparams")
    ptt.save(model.state_dict(), path)
    back = ptt.load(path, device="cpu")
    sd = model.state_dict()
    return dict(names=sorted(back), equal=all(
        torch.equal(back[k], sd[k]) for k in sd) and set(back) == set(sd))


GROUP_TIMEOUT_S = 300  # a group runs many cases; the suite runs loaded


def _run_group(fn, world, runs):
    """`torch_dist_workers.run_group` with this module's time limit."""
    import pickle
    import tempfile

    from paddle_tpu_torch.distributed import spawn

    with tempfile.TemporaryDirectory(prefix="torch-pp-") as out:
        spawn(fn, args=(out, runs), nprocs=world, timeout=GROUP_TIMEOUT_S)
        res = []
        for r in range(world):
            with open(os.path.join(out, f"rank{r}.pkl"), "rb") as f:
                res.append(pickle.load(f))
    return res


def start_groups(fn, runs_by_world):
    """Start one group of `fn(out_dir, runs)` a world on threads of this
    process; returns a function that waits for them and gives {world:
    [rank results]} (re-raising a group's error)."""
    import threading

    out, errors = {}, []

    def go(world, runs):
        try:
            out[world] = _run_group(fn, world, runs)
        except BaseException as e:  # handed to the caller on join
            errors.append(e)

    threads = [threading.Thread(target=go, args=(w, r), daemon=True)
               for w, r in runs_by_world.items()]
    for t in threads:
        t.start()

    def join():
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        return out

    return join


def pp_runs_main(out_dir, runs):
    """For each (tag, function name, kwargs) of `runs`, in one group, the
    function's result; each rank saves {tag: result}."""
    import paddle_tpu_torch.distributed as D

    fns = {"train": pp_train, "grads": grads_by_schedule,
           "info": pipeline_info, "seeded": seeded, "refusals": refusals,
           "zero": zero_refusal, "zero_pp": zero_pp_train,
           "zero_pp_clip": zero_pp_clip_and_inf, "ckpt_pp": ckpt_pp_run,
           "ckpt_generic": ckpt_generic,
           "fwd": generic_fwd, "vpp": generic_vpp,
           "1f1b": generic_1f1b,
           "layer": layer_train, "scaler_clip": layer_scaler_and_clip}
    from torch_zero_workers import count_updates_on
    from paddle_tpu_torch.optimizer import AdamW

    count_updates_on(AdamW)
    out = {}
    for tag, fn, kw in runs:
        if fn == "save":
            out[tag] = save_stage(out_dir=out_dir, rank=D.get_rank(), **kw)
        else:
            out[tag] = fns[fn](**kw)
    rank = D.get_rank()
    D.destroy_process_group()
    _save(out_dir, rank, out)
