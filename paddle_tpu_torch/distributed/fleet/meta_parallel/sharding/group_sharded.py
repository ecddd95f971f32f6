"""The ZeRO runtime behind `DygraphShardingOptimizer` (Paddle's
`group_sharded_stage{2,3}`), one process a rank over the port's
collectives.

The reference's stages are GSPMD layouts inside its compiled step
(`paddle_tpu/.../sharding/sharding_optimizer.py::stage_shardings`); here
they are real machinery over the ZeRO axis ("sharding" when the mesh has it
at degree > 1, else "dp"; `zero_axis_for`) of N ranks:

- **Buckets.** The parameters go in flat buckets: the model's blocks in
  reverse order (the order backward produces gradients), one dtype a
  bucket, at most `FLAGS_grad_bucket_mb` MiB each (<= 0: one parameter a
  bucket), a bucket never crossing a block. Each parameter starts on a
  `PARAM_ALIGN_BYTES` boundary of its bucket, and a bucket is padded to a
  multiple of N * `SLICE_ALIGN` elements, so each of the N slices starts
  16-byte aligned for the Adam kernel's vector path. Rank r owns the r-th
  contiguous 1/N of each bucket; a parameter meets a rank's slice in at
  most one piece, and the optimizer's state for a parameter (moments,
  master weight) covers that piece only.
- **Stage 1.** After the backward the gradients are whole; the step
  reduce_scatters (AVG) each bucket over the ZeRO axis (plus an all_reduce
  AVG over "dp" when both "dp" and "sharding" are > 1), updates the
  rank's pieces (one `_update_param` a piece: one Adam kernel launch) and
  all_gathers each bucket's updated slices back into the parameters.
- **Stage 2.** As stage 1, but each bucket's reduce_scatter runs in the
  backward, from a post-accumulate-grad hook, when the bucket's last
  gradient is in; the whole gradients are freed there, so after the
  backward a rank holds only its gradient slices.
- **Stage 3.** Between steps a rank stores only its parameter slices: each
  bucket's parameters are views of one flat buffer whose storage is
  resized to 0. A block (a child of an `nn.ModuleList`: a decoder layer;
  an embedding of an untied model) is gathered by a forward pre-hook and
  freed by a forward hook; a decoder block is gathered again by a hook on
  its output's gradient, before its backward, into the same storage, so
  every tensor autograd saved is valid again; a bucket is freed when its
  gradients are reduce_scattered. The rest of the model (the final norm,
  the head, a tied embedding: the "root" block) is gathered before the
  model's forward (a pre-hook on every module above a root parameter, or
  `begin`) and, in `jit.train_step`, freed after the loss and gathered
  again by a hook on the loss's gradient (the chunked LM-head loss reads
  the head's weight outside its module, and recomputes in the backward).

At world 2 every stage gives the same bits as the data-parallel step: a
reduce_scatter's sum of two terms does not depend on order, and each
update is element by element.

Under a pipeline schedule (`distributed/pipeline.py::run_schedule`, which
finds the engine of its stage's parameters, `engine_of`) a parameter's
gradient arrives once in each of the M microbatches' backwards. Stages 2-3
then accumulate it on the rank (in f32 for a narrower dtype, the
schedule's own rule: `begin_microbatches`) and reduce each bucket once, in
the backward of the last microbatch that reaches it; stage 1 reduces after
the schedule, as without one. Either way one reduce_scatter a bucket a
step. Stage 3 gathers a block around each microbatch's forward and again
before each microbatch's backward (any number of microbatches in flight:
every one's saved tensors view the same storage). A weight shared by
pipeline stages (a tied embedding, `pipeline.mark_shared`) takes a bucket
of its own, so its copies on two stages are sliced alike and the sum of
their gradient slices over those stages is exact (`sum_shared_slices`).
"""
from __future__ import annotations

import collections
import weakref

import torch
import torch.distributed as dist
from torch import nn

from .... import collective as _collective
from .... import mesh as _mesh

SLICE_ALIGN = 8          # elements: a rank's slice starts 16-byte aligned
PARAM_ALIGN_BYTES = 256  # a parameter's offset in its bucket


def zero_axis_for(mesh) -> str:
    """The axis ZeRO shards over: "sharding" when the mesh has it at
    degree > 1, else "dp"."""
    names = (mesh.mesh_dim_names or ()) if mesh is not None else ()
    if "sharding" in names and int(mesh["sharding"].size()) > 1:
        return "sharding"
    return "dp"


def _axis_rank(axis):
    g = _collective._resolve(axis)
    if g is None:
        return 0
    pg, _ = g
    return dist.get_rank(pg) if pg is not None else dist.get_rank()


def _is_embedding(mod):
    from .....nn import layers as _layers
    from ...layers.mpu.mp_layers import VocabParallelEmbedding

    return isinstance(mod, (nn.Embedding, _layers.Embedding,
                            VocabParallelEmbedding))


class _Unit:
    """A block of parameters gathered together at stage 3."""

    def __init__(self, kind, module, params):
        self.kind = kind          # "layer", "embedding" or "root"
        self.module = module
        self.params = params
        self.buckets = []


class _Bucket:
    def __init__(self, params, n, rank):
        self.params = params
        self.dtype = params[0].dtype
        self.device = params[0].device
        esize = params[0].element_size()
        align = max(PARAM_ALIGN_BYTES // esize, 1)
        off, self.offsets = 0, []
        for p in params:
            off = -(-off // align) * align
            self.offsets.append(off)
            off += p.numel()
        unit = n * SLICE_ALIGN
        self.size = max(-(-off // unit) * unit, unit)
        self.shard_size = self.size // n
        lo, hi = rank * self.shard_size, (rank + 1) * self.shard_size
        # (index in the bucket, [a, b) of the flattened parameter, offset
        # in the rank's slice)
        self.pieces = []
        for j, (p, o) in enumerate(zip(params, self.offsets)):
            a, b = max(lo, o), min(hi, o + p.numel())
            if a < b:
                self.pieces.append((j, a - o, b - o, a - lo))
        self.grad = None      # the rank's gradient slice
        self.ready = 0        # gradients accumulated in this backward
        self.full = None      # stage 3: the flat buffer the params view
        self.shard = None     # stage 3: the rank's parameter slice
        self.gathered = True


class ZeroEngine:
    """ZeRO stage `stage` (1-3) of `optimizer`'s parameters over the ZeRO
    axis of the global mesh. `model` (needed at stage 3) gives the blocks;
    without it the parameters form one block."""

    def __init__(self, optimizer, stage, model=None):
        if stage not in (1, 2, 3):
            raise ValueError(f"ZeRO stage {stage!r}: 1, 2 or 3")
        if stage == 3 and model is None:
            raise ValueError("ZeRO stage 3 needs the model (its blocks are "
                             "gathered around their forwards): use "
                             "group_sharded_parallel or build_train_step")
        self.opt = optimizer
        self.stage = stage
        self.model = model
        self.axis = zero_axis_for(_mesh.get_mesh(optional=True))
        self.n = _collective._size(self.axis)
        self.rank = _axis_rank(self.axis)
        self.dp_axis = "dp" if self.axis == "sharding" and \
            _mesh.axis_size("dp") > 1 else None
        params = [p for p in optimizer._parameter_list or ()
                  if p.requires_grad]
        self.params = params
        self._index = {id(p): i
                       for i, p in enumerate(optimizer._parameter_list)}
        self.units = _units(model, params)
        self.buckets = []
        for u in reversed(self.units):
            for b in _bucket_params(list(reversed(u.params))):
                bucket = _Bucket(b, self.n, self.rank)
                u.buckets.append(bucket)
                self.buckets.append(bucket)
        # id(p) -> (its bucket, its index there); never compare tensors
        # (a stage-3 parameter's storage is released between uses)
        self._where = {id(p): (b, j) for b in self.buckets
                       for j, p in enumerate(b.params)}
        # sequence-parallel parameters whose gradient this engine sums
        # over the SP axis (no hook of
        # register_sequence_parallel_allreduce_hooks came first)
        self._sp = {id(p) for p in params
                    if getattr(p, "sequence_parallel", False)
                    and not getattr(p, "_sp_allreduce_hook", False)}
        for p in params:
            if id(p) in self._sp:
                p._sp_allreduce_hook = True
        self.has_grad = set()
        self.traffic = collections.Counter()
        self._finished = False
        self._shared_summed = False
        self._handles = []
        # a pipeline's microbatches (stages 2-3): their count, each
        # parameter's arrivals and its gradient accumulated so far
        self._micro = None
        self._arrivals = collections.Counter()
        self._acc = {}
        me = weakref.ref(self)
        for p in params:
            p._zero_engine_ref = me
        if stage >= 2:
            # a weak reference: a tensor's hooks live in C++, where the
            # garbage collector cannot see a cycle back to the engine
            on_grad = weakref.WeakMethod(self._on_grad)
            for p in params:
                self._handles.append(p.register_post_accumulate_grad_hook(
                    lambda q, f=on_grad: f() and f()(q)))
        if stage == 3:
            self._slice_params()
            self._install_module_hooks(model)
            model._zero_engine = self

    # ---------------------------------------------------------- collectives
    def _reduce(self, b, flat):
        """The rank's slice of `flat` (a bucket's gradients) averaged over
        the ZeRO axis (and over "dp" where both are > 1)."""
        out = torch.empty(b.shard_size, dtype=flat.dtype, device=flat.device)
        _collective.reduce_scatter(out, list(flat.chunk(self.n)),
                                   op=_collective.ReduceOp.AVG,
                                   group=self.axis)
        self.traffic["reduce_scatter"] += 1
        self.traffic["reduce_scatter_bytes"] += flat.numel() * \
            flat.element_size()
        if self.dp_axis is not None:
            _collective.all_reduce(out, op=_collective.ReduceOp.AVG,
                                   group=self.dp_axis)
            self.traffic["all_reduce"] += 1
            self.traffic["all_reduce_bytes"] += out.numel() * \
                out.element_size()
        return out

    def _all_gather(self, full, mine):
        """Every rank's slice `mine` into the chunks of `full`."""
        pg, _ = _collective._resolve(self.axis)
        _collective.calls["all_gather"] += 1
        dist.all_gather(list(full.chunk(self.n)), mine, group=pg)
        self.traffic["all_gather"] += 1
        self.traffic["all_gather_bytes"] += full.numel() * full.element_size()

    # ------------------------------------------------------------ gradients
    def _sp_reduce(self, p):
        """A sequence-parallel parameter's gradient summed over its axis
        before the ZeRO reduction (see `_sp`)."""
        if id(p) in self._sp and p.grad is not None:
            from ...utils.sequence_parallel_utils import _sp_axis

            ax = _sp_axis()
            if ax is not None:
                _collective.all_reduce(p.grad, group=ax)

    @torch.no_grad()
    def _on_grad(self, p):
        """Stages 2-3: a parameter's gradient is in; reduce its bucket when
        the bucket's last one is (under a pipeline, at the parameter's last
        microbatch: `_accumulate`)."""
        if self._micro is not None and not self._accumulate(p):
            return
        self._sp_reduce(p)
        self.has_grad.add(id(p))
        b = self._where[id(p)][0]
        b.ready += 1
        if b.ready == len(b.params):
            self._reduce_bucket(b)

    def _accumulate(self, p):
        """One microbatch's gradient of `p` added to its sum on this rank
        (f32 for a narrower dtype; its `.grad` cleared); at the last of the
        `_micro` arrivals the sum becomes `p.grad` (in p's dtype) and True
        is returned."""
        n = self._arrivals[id(p)] = self._arrivals[id(p)] + 1
        g, p.grad = p.grad, None
        acc = self._acc.pop(id(p), None)
        if acc is None:
            acc = g if g.dtype == torch.float32 else g.float()
        else:
            acc.add_(g)
        if n < self._micro:
            self._acc[id(p)] = acc
            return False
        p.grad = acc if acc.dtype == p.dtype else acc.to(p.dtype)
        return True

    def begin_microbatches(self, m):
        """Before a pipeline schedule of `m` microbatches: stages 2-3
        accumulate each gradient over its `m` arrivals and reduce a bucket
        at its last (stage 1 reduces after the schedule anyway)."""
        if self.stage >= 2:
            self._micro = int(m)
            self._arrivals.clear()

    @torch.no_grad()
    def end_microbatches(self):
        """After the schedule: a gradient that arrived fewer than `m` times
        becomes `p.grad` as it stands, its bucket reduced with the rest by
        `grad_slices`."""
        if self._micro is None:
            return
        self._micro = None
        by_id = {id(p): p for p in self.params}
        for i, acc in self._acc.items():
            p = by_id[i]
            p.grad = acc if acc.dtype == p.dtype else acc.to(p.dtype)
            self._sp_reduce(p)
            self.has_grad.add(i)
            self._where[i][0].ready += 1
        self._acc.clear()

    def manages(self, p):
        """Whether this engine accumulates `p`'s gradient itself under a
        pipeline schedule (stages 2-3)."""
        return self.stage >= 2 and id(p) in self._where

    @torch.no_grad()
    def sum_shared_slices(self, link):
        """Each weight shared by pipeline stages (a bucket of its own,
        sliced alike on every stage that holds it): its gradient slice
        summed over those stages, once a step, after `grad_slices`."""
        if link is None or self._shared_summed:
            return
        self._shared_summed = True
        for b in self.buckets:
            stages = getattr(b.params[0], "pp_shared_stages", None)
            if stages is None:
                continue
            if b.grad is None:
                b.grad = torch.zeros(b.shard_size, dtype=b.dtype,
                                     device=b.device)
            _collective.all_reduce(b.grad, group=link.group_of(stages))

    @torch.no_grad()
    def broadcast_shared(self, link):
        """Stage 3: each shared weight's slice from the first stage that
        holds it (the copies' buckets are sliced alike)."""
        for b in self.buckets:
            stages = getattr(b.params[0], "pp_shared_stages", None)
            if stages is not None:
                _collective.broadcast(b.shard, src=link.ranks[stages[0]],
                                      group=link.group_of(stages))

    @torch.no_grad()
    def _reduce_bucket(self, b):
        flat = torch.zeros(b.size, dtype=b.dtype, device=b.device)
        for p, o in zip(b.params, b.offsets):
            if p.grad is not None:
                flat[o:o + p.numel()].copy_(p.grad.reshape(-1))
                p.grad = None
        out = self._reduce(b, flat)
        del flat
        if b.grad is None:
            b.grad = out
        else:
            b.grad.add_(out)
        b.ready = 0
        if self.stage == 3:
            self._free(b)

    @torch.no_grad()
    def grad_slices(self):
        """The rank's gradient slice of every bucket (None where no
        parameter of it took a gradient), reducing what the backward has
        not: at stage 1 every bucket, at stages 2-3 the buckets some of
        whose parameters took no gradient. Idempotent until `end`."""
        if not self._finished:
            for b in self.buckets:
                if self.stage == 1:
                    got = [p for p in b.params if p.grad is not None]
                    for p in got:
                        self._sp_reduce(p)
                    self.has_grad.update(id(p) for p in got)
                    if got:
                        self._reduce_bucket(b)
                elif b.ready:
                    self._reduce_bucket(b)
            self._finished = True
        return [b.grad for b in self.buckets]

    # --------------------------------------------------------------- update
    def _param_piece(self, b, j, lo, hi, s):
        if self.stage == 3:
            return b.shard[s:s + hi - lo]
        return b.params[j].detach().view(-1)[lo:hi]

    def _state(self, p, piece):
        i = self._index[id(p)]
        st = self.opt._accumulators.get(i)
        if st is None:
            st = self.opt._accumulators[i] = self.opt._init_state(piece)
        return st

    def pieces(self):
        """(parameter, its piece of the rank's slice as a tensor, the
        bucket's index, the piece's offset and length in the slice) for
        every piece this rank owns."""
        for k, b in enumerate(self.buckets):
            for j, lo, hi, s in b.pieces:
                yield b.params[j], self._param_piece(b, j, lo, hi, s), k, s, \
                    hi - lo

    def init_states(self):
        """Every piece's optimizer state (from the piece's current
        values), where it has none yet."""
        for p, piece, _, _, _ in self.pieces():
            self._state(p, piece)

    @torch.no_grad()
    def update(self, lr, grads, names=None, skip_missing=False,
               scale_lr=False, clip=None):
        """One `_update_param` a piece: `grads` one slice a bucket (None:
        zeros), `names` {id(p): name} for AdamW's `apply_decay_param_fun`
        ('' without), `skip_missing` leaves the pieces of parameters that
        took no gradient (the eager step), `scale_lr` multiplies by each
        parameter's `optimize_attr["learning_rate"]`, `clip` a clip over
        the (parameter, gradient piece) pairs (its global norm summed over
        the ZeRO axis). Returns the number of pieces updated."""
        todo = []
        for p, piece, k, s, n in self.pieces():
            if skip_missing and id(p) not in self.has_grad:
                continue
            g = grads[k][s:s + n] if grads[k] is not None \
                else torch.zeros_like(piece)
            todo.append((p, piece, g))
        if clip is not None:
            clipped = clip([(p, g) for p, _, g in todo])
            todo = [(p, piece, g) for (p, piece, _), (_, g) in
                    zip(todo, clipped)]
        for p, piece, g in todo:
            plr = lr
            if scale_lr:
                plr = lr * getattr(p, "optimize_attr", {}).get(
                    "learning_rate", 1.0)
            name = names.get(id(p), "") if names is not None else \
                (getattr(p, "name", None) or "")
            self.opt._update_param(piece, g, self._state(p, piece), plr,
                                   name)
        return len(todo)

    @torch.no_grad()
    def end(self, updated=True):
        """After a step: stages 1-2 all_gather the updated slices into the
        parameters (when `updated`), stage 3 frees every block still
        gathered; the gradient slices are dropped."""
        if updated and self.stage < 3:
            for b in self.buckets:
                self._gather_into_params(b)
        self.clear()

    def clear(self):
        """Drop the gradient slices (and, at stage 3, free what is
        gathered)."""
        for b in self.buckets:
            b.grad = None
            b.ready = 0
            if self.stage == 3:
                self._free(b)
        self.has_grad.clear()
        self._finished = False
        self._shared_summed = False
        self._micro = None
        self._acc.clear()

    @torch.no_grad()
    def _gather_into_params(self, b):
        mine = torch.zeros(b.shard_size, dtype=b.dtype, device=b.device)
        for j, lo, hi, s in b.pieces:
            mine[s:s + hi - lo].copy_(b.params[j].detach().view(-1)[lo:hi])
        full = torch.empty(b.size, dtype=b.dtype, device=b.device)
        self._all_gather(full, mine)
        for p, o in zip(b.params, b.offsets):
            p.detach().view(-1).copy_(full[o:o + p.numel()])

    # -------------------------------------------------------------- stage 3
    @torch.no_grad()
    def _slice_params(self):
        for b in self.buckets:
            full = torch.zeros(b.size, dtype=b.dtype, device=b.device)
            for p, o in zip(b.params, b.offsets):
                full[o:o + p.numel()].copy_(p.detach().reshape(-1))
            lo = self.rank * b.shard_size
            b.shard = full[lo:lo + b.shard_size].clone()
            for p, o in zip(b.params, b.offsets):
                p.data = full[o:o + p.numel()].view(p.shape)
            b.full = full
            b.gathered = True
            self._free(b)

    def _free(self, b):
        if b.gathered and b.full is not None:
            b.full.untyped_storage().resize_(0)
            b.gathered = False

    @torch.no_grad()
    def _gather(self, b):
        if b.gathered:
            return
        b.full.untyped_storage().resize_(b.size * b.full.element_size())
        b.gathered = True
        self._all_gather(b.full, b.shard)

    def gather_unit(self, u):
        for b in u.buckets:
            self._gather(b)

    def free_unit(self, u):
        for b in u.buckets:
            self._free(b)

    def _root(self):
        return next((u for u in self.units if u.kind == "root"), None)

    def begin(self):
        """Before a step's forward: gather the root block (stage 3)."""
        if self.stage == 3 and self._root() is not None:
            self.gather_unit(self._root())

    def after_forward(self, loss):
        """After the loss (stage 3): free the root block, and gather it
        again when the loss's gradient starts the backward."""
        root = self._root()
        if self.stage < 3 or root is None:
            return
        self.free_unit(root)
        if loss.requires_grad:
            loss.register_hook(lambda g: self.gather_unit(root))

    def _install_module_hooks(self, model):
        for u in self.units:
            if u.kind == "root":
                owners = {id(p) for p in u.params}
                for m in model.modules():
                    if any(id(p) in owners for p in m.parameters()):
                        self._handles.append(m.register_forward_pre_hook(
                            lambda mod, args, u=u: self.gather_unit(u)))
                continue
            self._handles.append(u.module.register_forward_pre_hook(
                lambda mod, args, u=u: self.gather_unit(u)))
            self._handles.append(u.module.register_forward_hook(
                lambda mod, args, out, u=u: self._after_block(u, out)))

    def _after_block(self, u, out):
        if torch._C._current_graph_task_id() != -1:
            return  # a recompute inside the backward: keep it gathered
        self.free_unit(u)
        if u.kind != "layer" or not torch.is_grad_enabled():
            return  # an embedding's backward does not read its weight
        outs = out if isinstance(out, (tuple, list)) else (out,)
        for t in outs:
            if isinstance(t, torch.Tensor) and t.requires_grad:
                t.register_hook(lambda g, u=u: self.gather_unit(u))

    # ------------------------------------------------------------- weights
    def piece_of(self, p):
        """(lo, hi, values) of `p`'s piece in this rank's slice (stage 3),
        lo == hi where it has none."""
        b, j = self._where[id(p)]
        for jj, lo, hi, s in b.pieces:
            if jj == j:
                return lo, hi, b.shard[s:s + hi - lo]
        return 0, 0, b.shard[:0]

    def piece_range(self, p):
        """(lo, hi): the elements of `p` (flattened) in this rank's slice;
        lo == hi where it has none."""
        b, j = self._where[id(p)]
        for jj, lo, hi, _ in b.pieces:
            if jj == j:
                return lo, hi
        return 0, 0

    @torch.no_grad()
    def load_param(self, p, value):
        """Write the whole parameter `value` into this rank's piece of
        `p` (stage 3)."""
        lo, hi, piece = self.piece_of(p)
        piece.copy_(value.reshape(-1)[lo:hi].to(piece.dtype))

    def detach(self):
        """Remove the hooks (stages 1-2: the parameters stay whole)."""
        for h in self._handles:
            h.remove()
        self._handles = []
        for p in self.params:
            if engine_of([p]) is self:
                del p._zero_engine_ref


def engine_of(params):
    """The `ZeroEngine` that holds the first of `params` that one holds,
    or None."""
    for p in params:
        ref = getattr(p, "_zero_engine_ref", None)
        eng = ref() if ref is not None else None
        if eng is not None:
            return eng
    return None


def held_bytes(optimizer, engine=None):
    """{"state", "grads", "params"}: the bytes `optimizer`'s state tensors
    hold, the gradients (each parameter's whole `.grad` and the engine's
    slices) and the parameters (whole; at stage 3 the slices plus what is
    gathered) on this rank."""
    def nbytes(t):
        return t.numel() * t.element_size()

    params = [p for p in optimizer._parameter_list or ()]
    state = sum(nbytes(v) for st in optimizer._accumulators.values()
                for v in st.values() if isinstance(v, torch.Tensor))
    grads = sum(nbytes(p.grad) for p in params if p.grad is not None)
    if engine is not None:
        grads += sum(nbytes(b.grad) for b in engine.buckets
                     if b.grad is not None)
    if engine is not None and engine.stage == 3:
        held = sum(nbytes(b.shard) + (nbytes(b.full) if b.gathered else 0)
                   for b in engine.buckets)
        sliced = {id(p) for b in engine.buckets for p in b.params}
        held += sum(nbytes(p) for p in params if id(p) not in sliced)
    else:
        held = sum(nbytes(p) for p in params)
    return {"state": state, "grads": grads, "params": held}


def _units(model, params):
    """The blocks of `params`: each child of an `nn.ModuleList` of
    `model`, each embedding of an untied model, and the root (the rest);
    without a model, one root block."""
    if model is None:
        return [_Unit("root", None, list(params))]
    want = {id(p) for p in params}
    taken, units = set(), []

    def take(kind, module, found):
        ps = [p for p in found if id(p) in want and id(p) not in taken]
        if ps:
            taken.update(id(p) for p in ps)
            units.append(_Unit(kind, module, ps))

    for mod in model.modules():
        if isinstance(mod, nn.ModuleList):
            for child in mod:
                take("layer", child, child.parameters())
    cfg = getattr(model, "config", None)
    if not getattr(cfg, "tie_word_embeddings", False):
        for mod in model.modules():
            if _is_embedding(mod):
                take("embedding", mod, mod.parameters(recurse=False))
    rest = [p for p in params if id(p) not in taken]
    if rest:
        units.append(_Unit("root", model, rest))
    return units


def _bucket_params(params):
    """`params` (one block, in reverse order) in runs of one dtype of at
    most FLAGS_grad_bucket_mb MiB (<= 0: one parameter a run); a weight
    shared by pipeline stages in a run of its own."""
    from .....framework import config as _config

    cap = int(_config.get_flag("FLAGS_grad_bucket_mb", 25)) << 20
    out, cur, cur_bytes = [], [], 0
    for p in params:
        if getattr(p, "pp_shared_stages", None) is not None:
            if cur:
                out.append(cur)
            out.append([p])
            cur, cur_bytes = [], 0
            continue
        nbytes = p.numel() * p.element_size()
        if cur and (p.dtype != cur[0].dtype or cur_bytes + nbytes > cap):
            out.append(cur)
            cur, cur_bytes = [], 0
        cur.append(p)
        cur_bytes += nbytes
    if cur:
        out.append(cur)
    return out
