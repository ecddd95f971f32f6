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


def _fleet(pp=1, dp=1, tp=1, accumulate=1, mode="1F1B"):
    """fleet.init over CPU ranks at these degrees (once while they stay the
    same: each init makes every group anew); the strategy's pipeline
    configs set each call. (fleet, hcg)."""
    import paddle_tpu_torch.distributed as D
    from paddle_tpu_torch.distributed import fleet

    torch.set_num_threads(1)
    D.init_parallel_env(device="cpu", timeout=60)
    if _DEGREES != [(pp, dp, tp)]:
        s = fleet.DistributedStrategy()
        s.hybrid_configs = dict(dp_degree=dp, mp_degree=tp, pp_degree=pp)
        fleet.init(is_collective=True, strategy=s)
        _DEGREES[:] = [(pp, dp, tp)]
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
    if how == "fleet":
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
    """ZeRO stage 2 with pp 2 x dp 2: the message."""
    from paddle_tpu_torch.models import build_train_step
    from paddle_tpu_torch.optimizer import AdamW

    _fleet(pp=2, dp=2)
    model = _model("llama", 4, state)
    return _raises(lambda: build_train_step(model, AdamW(
        learning_rate=LR, parameters=model.parameters()), sharding_stage=2))


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
           "zero": zero_refusal, "fwd": generic_fwd, "vpp": generic_vpp,
           "1f1b": generic_1f1b,
           "layer": layer_train, "scaler_clip": layer_scaler_and_clip}
    out = {}
    for tag, fn, kw in runs:
        if fn == "save":
            out[tag] = save_stage(out_dir=out_dir, rank=D.get_rank(), **kw)
        else:
            out[tag] = fns[fn](**kw)
    rank = D.get_rank()
    D.destroy_process_group()
    _save(out_dir, rank, out)
