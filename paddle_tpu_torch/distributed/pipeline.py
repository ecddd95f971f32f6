"""Pipeline parallelism (counterpart of `paddle_tpu/distributed/pipeline.py`):
the schedules, host-orchestrated, one process a rank.

The reference compiles its schedule into one SPMD program: every process
holds every stage's weights as stacked arrays sharded over "pp", a
`lax.scan` inside a `shard_map` runs the ticks, `ppermute` moves the
activations, and the embedding and head are replicated over "pp". The port
takes PaddlePaddle's own design instead. Each rank holds only its stage's
layers (`stage_layer_ids`), the embedding on the first stage and the final
norm and head on the last; the schedule is a list of forward and backward
ops a rank runs in order (`schedule_program`); activations go forward and
cotangents backward by point-to-point send / recv over the "pp" group
(`fleet/meta_parallel/pp_utils/p2p_communication.py`). The numbers are the
reference's: the loss is the mean of the M microbatch losses, and each
parameter's gradient is the sum over microbatches of d(loss_m / M),
accumulated in f32 for parameters of a narrower dtype (the reference's
per-stage f32 accumulation), then cast to the parameter's dtype.

The schedules (`schedule_program`):
- "gpipe": every forward, then every backward (O(M) microbatches in
  flight on a stage);
- "1f1b": S - 1 - stage warm-up forwards, then one forward and one
  backward in turn, then the cool-down backwards (at most S - stage in
  flight: the reference's memory contract);
- "vpp": Megatron's interleaved schedule: rank r holds the logical stages
  r, S + r, 2S + r, ... (v chunks); its op order is the rule of the
  reference's `_vpp_schedule` (warm-up min(Mv, 2(S - r - 1) + (v - 1)S)
  forwards, then forward and backward in turn; the n-th forward is chunk
  (n // S) % v of microbatch (n // Sv) S + n % S, the backwards mirror it
  with the chunks reversed). It needs M % S == 0.

Under ZeRO (a `group_sharded.ZeroEngine` over the stage's parameters,
found by `run_schedule` from them) stages 2-3 accumulate each gradient
over the microbatches themselves and reduce each bucket once, in the
last microbatch's backward; `reduce_gradients` gives the update its
slices (stage 1 reducing them then), each shared weight's slice summed
over its stages.

The generic entries `spmd_pipeline` (forward only), `spmd_pipeline_1f1b`
and `spmd_pipeline_vpp` keep the reference's contracts over this rank's own
parameters: `stage_params` is the rank's block (for VPP, leaves with a
leading [v] dimension, chunk j at [j]), not a stacked array of every
stage. Buffers carried through stage layers (`stage_buffers`) raise: the
port has no BatchNorm yet (ROADMAP Queue 1 item 8 A). The reference's
stacking utilities (`stack_layer_params`, `make_stage_fn`, ...) have no
counterpart: no rank holds another stage's layers.
"""
from __future__ import annotations

from typing import Callable, List, Sequence

import numpy as np
import torch
from torch.utils import _pytree as pytree

from . import collective as _c
from . import mesh as _mesh

SCHEDULES = ("1f1b", "gpipe", "vpp")


def stage_layer_ids(num_layers: int, stage: int, num_stages: int,
                    virtual: int = 1) -> List[int]:
    """The global indices of the layers pipeline rank `stage` holds, in
    order: the contiguous block of logical stages j * S + stage for j in
    range(virtual), each num_layers / (S * virtual) layers (the
    reference's stacked layout, `vpp_stack_layer_params` for virtual > 1).
    Raises the reference's ValueError where S * virtual does not divide
    the layers."""
    S, v = int(num_stages), int(virtual)
    if num_layers % (S * v):
        raise ValueError(
            f"{num_layers} layers not divisible by pp*vpp={S}*{v}")
    lc = num_layers // (S * v)
    return [(j * S + stage) * lc + i for j in range(v) for i in range(lc)]


def microbatch(x, num_microbatches: int):
    """[B, ...] -> [M, B // M, ...]: microbatch m holds the contiguous rows
    m B / M .. (m + 1) B / M - 1, as the reference reshapes."""
    b = x.shape[0]
    if b % num_microbatches:
        raise ValueError(
            f"batch {b} not divisible by num_microbatches {num_microbatches}")
    return x.reshape((num_microbatches, b // num_microbatches)
                     + tuple(x.shape[1:]))


def schedule_program(schedule: str, num_stages: int, stage: int,
                     num_microbatches: int, virtual: int = 1):
    """Rank `stage`'s ops in order: ("f" or "b", chunk, microbatch)."""
    S, r, M, v = int(num_stages), int(stage), int(num_microbatches), \
        int(virtual)
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown pipeline schedule {schedule!r}; "
                         "use '1f1b', 'gpipe' or 'vpp'")
    if schedule == "gpipe":
        return [("f", 0, m) for m in range(M)] + \
            [("b", 0, m) for m in range(M)]
    if schedule == "1f1b" or v == 1:
        w = min(M, S - 1 - r)
        ops = [("f", 0, m) for m in range(w)]
        for i in range(M - w):
            ops += [("f", 0, w + i), ("b", 0, i)]
        return ops + [("b", 0, m) for m in range(M - w, M)]
    if M % S:
        raise ValueError(f"VPP requires microbatches ({M}) % pp ({S}) == 0")
    total = M * v

    def op(kind, n):
        g, rem = divmod(n, S * v)
        j = (rem // S) % v
        return (kind, j if kind == "f" else v - 1 - j, g * S + rem % S)

    warmup = min(total, (S - r - 1) * 2 + (v - 1) * S)
    ops = [op("f", n) for n in range(warmup)]
    nf, nb = warmup, 0
    while nf < total or nb < total:
        if nf < total:
            ops.append(op("f", nf))
            nf += 1
        if nb < total:
            ops.append(op("b", nb))
            nb += 1
    return ops


class Stage:
    """What one rank runs in a schedule: `chunks`, its v chunk functions
    (activation -> activation); `embed`, a microbatch's inputs -> the
    first logical stage's input; `head_loss`, (the last logical stage's
    output, a microbatch's labels) -> that microbatch's loss; `act`, a
    microbatch's inputs -> (shape, dtype) of the activation between any
    two stages, or None to announce them once a chunk (`send_meta`);
    `params`, the parameters whose gradients the schedule accumulates (in
    f32 for narrower dtypes)."""

    def __init__(self, chunks, embed=None, head_loss=None, act=None,
                 params=()):
        self.chunks = list(chunks)
        self.embed = embed
        self.head_loss = head_loss
        self.act = act
        self.params = list(params)


class _Forwards:
    """The forward half of a run on this rank: chunk j's input (the
    embedding on the first logical stage, else the previous stage's
    activation, its shape and dtype from `Stage.act` or announced once a
    chunk), its output, sent on unless it is the last logical stage's."""

    def __init__(self, stage, link, device):
        self.stage, self.link, self.device = stage, link, device
        self.S = 1 if link is None else link.num_stages
        self.r = 0 if link is None else link.stage
        self.last = self.S * len(stage.chunks) - 1
        self.meta_in, self.meta_out = {}, set()

    def run(self, j, inputs, grad):
        """(input, output, logical stage) of chunk j on one microbatch's
        `inputs`; a received input requires grad where `grad`."""
        st, link = self.stage, self.link
        k = j * self.S + self.r
        if k == 0:
            x = st.embed(inputs)
        else:
            if st.act is not None:
                shape, dtype = st.act(inputs)
            else:
                if j not in self.meta_in:
                    self.meta_in[j] = link.recv_meta()
                shape, dtype = self.meta_in[j]
            x = link.recv_forward(shape, dtype, self.device)
            if grad:
                x.requires_grad_()
        y = st.chunks[j](x)
        if k != self.last:
            if st.act is None and j not in self.meta_out:
                link.send_meta(y)
                self.meta_out.add(j)
            link.send_forward(y)
        return x, y, k


def run_schedule(stage: Stage, link, inputs: Sequence, labels: Sequence,
                 schedule: str = "1f1b", device=None, trace=None,
                 loss_scale: float = 1.0):
    """Run this rank's program of `schedule` over the M microbatches of
    `inputs` and `labels` (read only on the first and last logical
    stages). `link` is the rank's `P2PLink` (None: one stage). The
    gradients of loss_scale * loss_m / M land in the parameters' `.grad`;
    returns the loss, the mean of the microbatch losses as f32, on every
    rank of the "pp" group. `trace`, a list, receives each op as it runs
    (with the number of microbatches in flight)."""
    S = 1 if link is None else link.num_stages
    r = 0 if link is None else link.stage
    v = len(stage.chunks)
    M = len(inputs)
    ops = schedule_program(schedule, S, r, M, v)
    last = S * v - 1
    inv_m = float(np.float32(1.0 / M))
    seed = inv_m * float(loss_scale)
    zero = _engine_of(stage.params)
    # ZeRO stages 2-3 accumulate their own parameters' gradients over the
    # microbatches (reducing each bucket once, at its last microbatch)
    narrow = [p for p in stage.params if p.requires_grad
              and p.dtype != torch.float32
              and not (zero is not None and zero.manages(p))]
    if zero is not None:
        zero.begin_microbatches(M)
    acc = {}
    saved, losses = {}, []
    fwd = _Forwards(stage, link, device)

    def fold_narrow():
        for p in narrow:
            if p.grad is not None:
                if id(p) in acc:
                    acc[id(p)].add_(p.grad)
                else:
                    acc[id(p)] = p.grad.float()
                p.grad = None

    for kind, j, m in ops:
        k = j * S + r
        if kind == "f":
            x, y, _ = fwd.run(j, inputs[m], grad=True)
            if k == last:
                y = stage.head_loss(y, labels[m])
                losses.append(y.detach())
            saved[(j, m)] = (x, y)
        else:
            x, y = saved.pop((j, m))
            g = torch.full_like(y, seed) if k == last else \
                link.recv_backward(y.shape, y.dtype, y.device)
            torch.autograd.backward(y, g)
            if k != 0:
                link.send_backward(x.grad if x.grad is not None
                                   else torch.zeros_like(x))
            if narrow:
                fold_narrow()
        if trace is not None:
            trace.append((kind, j, m, len(saved)))
    if link is not None:
        link.finish()
    if zero is not None:
        zero.end_microbatches()
    for p in narrow:
        if id(p) in acc:
            p.grad = acc[id(p)].to(p.dtype)
    dev = device if device is not None else (
        losses[0].device if losses else torch.device("cpu"))
    return _mean_loss(losses, link, inv_m, dev)


def _engine_of(params):
    from .fleet.meta_parallel.sharding.group_sharded import engine_of

    return engine_of(params)


def reduce_gradients(params, link):
    """After a schedule, the gradients of this rank's stage `params` as
    the update reads them: without ZeRO each shared weight's gradient
    summed over its stages (`allreduce_shared_weight_gradients`); under
    ZeRO the engine's slices, reduced once a bucket (`grad_slices`), each
    shared weight's slice summed over its stages. Returns the engine, or
    None."""
    zero = _engine_of(params)
    if zero is None:
        if link is not None:
            allreduce_shared_weight_gradients(params, link)
        return None
    zero.grad_slices()
    zero.sum_shared_slices(link)
    return zero


def _mean_loss(losses, link, inv_m, dev):
    """The mean of the last stage's microbatch losses (f32), broadcast
    over the "pp" group."""
    if losses:
        loss = torch.stack([v_.float() for v_ in losses]).sum() \
            * np.float32(inv_m)
    else:
        loss = torch.zeros((), dtype=torch.float32, device=dev)
    if link is not None:
        loss = loss.reshape(1)
        _c.broadcast(loss, src=link.ranks[link.num_stages - 1],
                     group=link.fwd_group)
        loss = loss[0]
    return loss


@torch.no_grad()
def run_forward(stage: Stage, link, inputs: Sequence, labels: Sequence,
                compute_loss=True, device=None):
    """The forward of every microbatch through this rank's chunks,
    microbatch by microbatch (no gradients): with `compute_loss`, the mean
    of the microbatch losses on every rank of the "pp" group; else the
    last stage's outputs joined along the rows (None on other ranks)."""
    fwd = _Forwards(stage, link, device)
    outs = []
    for m in range(len(inputs)):
        for j in range(len(stage.chunks)):
            _, y, k = fwd.run(j, inputs[m], grad=False)
            if k == fwd.last:
                outs.append(stage.head_loss(y, labels[m]) if compute_loss
                            else y)
    if link is not None:
        link.finish()
    if compute_loss:
        dev = device if device is not None else torch.device("cpu")
        return _mean_loss(outs, link, float(np.float32(1.0 / len(inputs))),
                          dev)
    return torch.cat(outs) if outs else None


def _axis(mesh, axis_name):
    mesh = mesh or _mesh.get_mesh(optional=True)
    if mesh is None or axis_name not in (mesh.mesh_dim_names or ()) or \
            int(mesh[axis_name].size()) == 1:
        return None
    from .fleet.meta_parallel.pp_utils.p2p_communication import link_for

    return link_for(mesh, axis_name)


def _no_buffers(stage_buffers):
    if stage_buffers is not None:
        raise NotImplementedError(
            "stage_buffers: buffers carried through pipeline stages "
            "(BatchNorm statistics) wait for the port's BatchNorm (ROADMAP "
            "Queue 1 item 8 A)")


def spmd_pipeline(stage_fn: Callable, stage_params, microbatches, *,
                  mesh=None, axis_name: str = "pp", stage_buffers=None):
    """The forward of an S-stage pipeline over `axis_name`:
    `stage_fn(stage_params, x) -> y`, this rank's stage on its own
    parameters (x and y of one shape and dtype), over the M microbatches
    of `microbatches` ([M, ...], given on every rank; the first stage reads
    them). Returns the last stage's [M, ...] outputs on every rank of the
    axis (broadcast from the last stage), as the reference returns them
    replicated. Without the axis (or at size 1), the stages' map."""
    _no_buffers(stage_buffers)
    link = _axis(mesh, axis_name)
    if link is None:
        return torch.stack([stage_fn(stage_params, mb)
                            for mb in microbatches])
    S, r = link.num_stages, link.stage
    shape, dtype = tuple(microbatches.shape[1:]), microbatches.dtype
    dev = microbatches.device
    outs = []
    with torch.no_grad():
        for mb in microbatches:
            x = mb if r == 0 else link.recv_forward(shape, dtype, dev)
            y = stage_fn(stage_params, x)
            if r == S - 1:
                outs.append(y)
            else:
                link.send_forward(y)
    link.finish()
    out = torch.stack(outs) if outs else torch.empty(
        (len(microbatches),) + shape, dtype=dtype, device=dev)
    _c.broadcast(out, src=link.ranks[S - 1], group=link.fwd_group)
    return out


def _leaves(tree):
    return pytree.tree_map(lambda t: t.detach().clone().requires_grad_(),
                           tree)


def _grads(tree):
    return pytree.tree_map(
        lambda t: t.grad if t.grad is not None else torch.zeros_like(t),
        tree)


def _train_entry(chunk_fns, sp, microbatches, head_fn, head_params, targets,
                 link, schedule):
    """The shared body of `spmd_pipeline_1f1b` / `_vpp`."""
    hp = _leaves(head_params)
    xs = microbatches.detach().clone().requires_grad_()
    M = microbatches.shape[0]
    act = (tuple(microbatches.shape[1:]), microbatches.dtype)
    stage = Stage(chunk_fns, embed=lambda x: x,
                  head_loss=lambda y, t: head_fn(hp, y, t),
                  act=lambda _: act)
    loss = run_schedule(stage, link, [xs[m] for m in range(M)],
                        [targets[m] for m in range(M)], schedule,
                        device=microbatches.device)
    d_sp, d_hp = _grads(sp), _grads(hp)
    d_x = xs.grad if xs.grad is not None else torch.zeros_like(xs)
    if link is not None:
        for g in pytree.tree_leaves(d_hp):
            _c.all_reduce(g, group=link.fwd_group)
        _c.broadcast(d_x, src=link.ranks[0], group=link.fwd_group)
    return loss, d_sp, d_hp, d_x


def spmd_pipeline_1f1b(stage_fn, stage_params, microbatches, head_fn,
                       head_params, targets, *, mesh=None,
                       axis_name: str = "pp", stage_buffers=None):
    """The 1F1B train schedule over `axis_name`: `stage_fn(params, x) ->
    y` on this rank's `stage_params`; `head_fn(head_params, y,
    target_mb)` -> one microbatch's mean loss, at the last stage.
    Returns (loss, d_stage_params, d_head_params, d_inputs): the mean over
    the M microbatches (every rank), the gradients of this rank's
    `stage_params`, those of `head_params` (summed over the axis: every
    rank), and the [M, ...] cotangents of `microbatches` (from the first
    stage: every rank)."""
    _no_buffers(stage_buffers)
    link = _axis(mesh, axis_name)
    sp = _leaves(stage_params)
    return _train_entry([lambda x: stage_fn(sp, x)], sp, microbatches,
                        head_fn, head_params, targets, link, "1f1b")


def spmd_pipeline_vpp(stage_fn, stage_params, microbatches, head_fn,
                      head_params, targets, *, num_chunks: int, mesh=None,
                      axis_name: str = "pp", stage_buffers=None):
    """The interleaved (VPP) schedule: as `spmd_pipeline_1f1b`, with
    `stage_params` leaves of a leading [v] dimension (`num_chunks`): [j]
    is this rank's chunk j, the logical stage j * S + rank; `stage_fn`
    receives one chunk's parameters. d_stage_params has the same layout.
    Needs M % S == 0."""
    _no_buffers(stage_buffers)
    link = _axis(mesh, axis_name)
    v = int(num_chunks)
    sp = _leaves(stage_params)

    def chunk(j):
        return lambda x: stage_fn(pytree.tree_map(lambda p: p[j], sp), x)

    if link is None:
        def chain(x):
            for j in range(v):
                x = chunk(j)(x)
            return x

        return _train_entry([chain], sp, microbatches, head_fn, head_params,
                            targets, None, "1f1b")
    return _train_entry([chunk(j) for j in range(v)], sp, microbatches,
                        head_fn, head_params, targets, link, "vpp")


# ---------------------------------------------------------------------------
# weights shared between stages (Paddle's SharedLayerDesc: a tied embedding)


def mark_shared(param, stages, owner):
    """Mark `param` as one copy of a weight that the pipeline `stages`
    each hold; `owner`: this copy is the first stage's (the clip counts
    only the owner's gradient)."""
    param.pp_shared_stages = tuple(sorted(stages))
    param.pp_shared_owner = bool(owner)


def is_shared_copy(param):
    """Whether `param` is a copy of a shared weight that another stage
    owns."""
    return getattr(param, "pp_shared_stages", None) is not None and \
        not getattr(param, "pp_shared_owner", True)


def shared_params(params):
    return [p for p in params
            if getattr(p, "pp_shared_stages", None) is not None]


@torch.no_grad()
def broadcast_shared_weights(params, link):
    """Each shared weight from the first stage that holds it, to the
    others (at build); a ZeRO stage-3 engine's shared slices where the
    parameters are stored as slices."""
    zero = _engine_of(params)
    if zero is not None and zero.stage == 3:
        zero.broadcast_shared(link)
        return
    for p in shared_params(params):
        _c.broadcast(p.data, src=link.ranks[p.pp_shared_stages[0]],
                     group=link.group_of(p.pp_shared_stages))


@torch.no_grad()
def allreduce_shared_weight_gradients(params, link):
    """Each shared weight's gradient summed over the stages that hold it
    (Paddle's `allreduce_shared_weight_gradients`), after the backward."""
    for p in shared_params(params):
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        _c.all_reduce(p.grad, group=link.group_of(p.pp_shared_stages))


def _has_pp(mesh):
    return "pp" in (getattr(mesh, "mesh_dim_names", None) or ())


def pp_size(mesh=None) -> int:
    """The "pp" degree of `mesh` (default: the global mesh); 1 without
    the axis."""
    mesh = mesh if mesh is not None else _mesh.get_mesh(optional=True)
    return int(mesh["pp"].size()) if _has_pp(mesh) else 1


def pp_rank(mesh=None) -> int:
    """This rank's stage on `mesh`'s "pp" axis; 0 without the axis."""
    mesh = mesh if mesh is not None else _mesh.get_mesh(optional=True)
    return int(mesh.get_local_rank("pp")) if _has_pp(mesh) else 0


class Layout:
    """A model's pipeline layout on this rank, from the global mesh's "pp"
    axis: `num_stages` S, `stage`, `virtual` chunks (1 without the axis),
    `layer_ids` (the decoder layers it holds, `stage_layer_ids`), `first`
    and `last` (whether it holds the embedding, and the final norm and
    head); `split` when S > 1."""

    def __init__(self, num_layers: int, virtual: int = 1, mesh=None):
        self.num_stages = pp_size(mesh)
        self.stage = pp_rank(mesh)
        self.split = self.num_stages > 1
        self.virtual = int(virtual) if self.split else 1
        self.layer_ids = stage_layer_ids(
            num_layers, self.stage, self.num_stages, self.virtual) \
            if self.split else list(range(num_layers))
        self.first = self.stage == 0
        self.last = self.stage == self.num_stages - 1

    def refuse(self, what):
        """Raise where the model is split over stages: `what` needs the
        whole model in one process."""
        if self.split:
            raise NotImplementedError(
                f"{what}: this model is pipeline stage {self.stage} of "
                f"{self.num_stages} (layers {self.layer_ids[0]}.."
                f"{self.layer_ids[-1]}); train it through build_train_step "
                "or fleet.distributed_model's PipelineParallel")


class StageLayers(torch.nn.Module):
    """The decoder layers a pipeline rank holds, each registered under its
    global index (so parameter names are the whole model's:
    `llama.layers.5.mlp.up_proj.weight`); iterates, indexes and slices like
    a ModuleList in the order held."""

    def __init__(self, layers):
        super().__init__()
        for i, layer in layers.items():
            self.add_module(str(i), layer)

    def __iter__(self):
        return iter(self._modules.values())

    def __len__(self):
        return len(self._modules)

    def __getitem__(self, idx):
        return list(self._modules.values())[idx]


def chunk_layers(layers: Sequence, virtual: int) -> List[list]:
    """A rank's held layers cut into its `virtual` chunks (equal runs, in
    order)."""
    n = len(layers) // int(virtual)
    return [list(layers[j * n:(j + 1) * n]) for j in range(int(virtual))]


__all__ = ["Layout", "SCHEDULES", "Stage", "StageLayers",
           "allreduce_shared_weight_gradients",
           "broadcast_shared_weights", "chunk_layers", "is_shared_copy",
           "mark_shared", "microbatch", "pp_rank", "pp_size",
           "reduce_gradients", "run_forward", "run_schedule",
           "schedule_program", "spmd_pipeline", "spmd_pipeline_1f1b",
           "spmd_pipeline_vpp", "stage_layer_ids"]
