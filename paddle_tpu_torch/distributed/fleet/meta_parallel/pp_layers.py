"""`LayerDesc`, `SharedLayerDesc` and `PipelineLayer` (counterpart of
`paddle_tpu/distributed/fleet/meta_parallel/pp_layers.py`).

The stage assignment is the reference's `_partition`: "uniform" cuts the
entries evenly (`np.linspace`), "layer:<Name>" starts a stage at every
(len(marks) // stages)-th entry whose type is <Name>. As in Paddle, and
unlike the reference (which builds every stage in every process), a rank
builds only the entries of its own stage, the stage counted from the
global mesh's "pp" axis (`num_stages` must equal it). With
`num_virtual_pipeline_stages` v the entries are cut into S * v logical
stages and rank r builds r, S + r, 2S + r, ... (its chunks, in order).
Without a "pp" axis the layer builds every stage, as the reference's does.

A `SharedLayerDesc` (a tied embedding) is built once on each stage that
uses its key; at pp > 1 its weight (`shared_weight_attr`) is broadcast from
the first such stage at build, and its gradient is summed over those stages
after each backward (`pipeline.allreduce_shared_weight_gradients`, which
`PipelineParallel` calls). The clip counts it once (on the first stage).
Stage layers that carry buffers raise: the schedules carry no buffers
(BatchNorm statistics wait for ROADMAP Queue 1 item 8 A).
"""
from __future__ import annotations

from typing import List

import numpy as np
from torch import nn

from ... import pipeline as _pipe


class LayerDesc:
    def __init__(self, layer_func, *inputs, **kwargs):
        self.layer_func = layer_func
        self.inputs = inputs
        self.kwargs = kwargs
        if not (isinstance(layer_func, type)
                and issubclass(layer_func, nn.Module)):
            raise TypeError("LayerDesc expects an nn.Layer subclass")

    def build_layer(self):
        return self.layer_func(*self.inputs, **self.kwargs)

    def __repr__(self):
        return f"LayerDesc({self.layer_func.__name__})"


class SharedLayerDesc(LayerDesc):
    def __init__(self, key, layer_func, forward_func=None, shared_weight_attr
                 ="weight", *inputs, **kwargs):
        super().__init__(layer_func, *inputs, **kwargs)
        self.layer_name = key
        self.forward_func = forward_func
        self.shared_weight_attr = shared_weight_attr


def _type_name(entry):
    """The type name `_partition`'s "layer:<Name>" matches: a desc's layer
    class, else the entry's own type (the reference reads it off the built
    entries)."""
    if isinstance(entry, LayerDesc):
        return entry.layer_func.__name__
    return type(entry).__name__


class PipelineLayer(nn.Module):
    def __init__(self, layers, num_stages=None, topology=None, loss_fn=None,
                 seg_method="uniform", recompute_interval=0,
                 recompute_ctx=None, num_virtual_pipeline_stages=None):
        super().__init__()
        self._loss_fn = loss_fn
        pp = _pipe.pp_size()
        if num_stages is None:
            num_stages = topology.get_dim("pipe") if topology is not None \
                else pp
        self._num_stages = int(num_stages or 1)
        self._num_virtual = int(num_virtual_pipeline_stages or 1)
        if pp > 1 and pp != self._num_stages:
            raise ValueError(f"PipelineLayer: num_stages {self._num_stages} "
                             f"but the mesh's pp axis has {pp} ranks")
        self._split = pp > 1
        self._stage_id = _pipe.pp_rank() if self._split else 0
        self._seg_method = seg_method
        self.descs = list(layers)
        S, v = self._num_stages, self._num_virtual
        self._segments = self._partition(len(self.descs), S * v)
        held = [i for i in range(len(self.descs))
                if not self._split or self._segments[i] % S == self._stage_id]
        self._shared_layers = {}
        self._shared_stages = {}
        for i, d in enumerate(self.descs):
            if isinstance(d, SharedLayerDesc):
                self._shared_stages.setdefault(d.layer_name, set()).add(
                    self._segments[i] % S)
        built = []
        self._held = held
        for i in held:
            d = self.descs[i]
            if isinstance(d, SharedLayerDesc):
                if d.layer_name not in self._shared_layers:
                    self._shared_layers[d.layer_name] = d.build_layer()
                built.append((self._shared_layers[d.layer_name],
                              d.forward_func))
            elif isinstance(d, LayerDesc):
                built.append((d.build_layer(), None))
            elif isinstance(d, nn.Module) or callable(d):
                built.append((d, None))
            else:
                raise TypeError(f"bad pipeline entry {d!r}")
        self.run_function = built
        self._layer_list = nn.ModuleList(
            [l for l, _ in built if isinstance(l, nn.Module)])
        if self._split:
            self._share()

    def _share(self):
        """Mark each shared weight, make the group of the stages that hold
        it (every rank, every key, in the descs' order) and broadcast it
        from the first of them."""
        from .pp_utils.p2p_communication import link_for

        link = link_for()
        params = []
        for key in sorted(self._shared_stages):
            stages = tuple(sorted(self._shared_stages[key]))
            if len(stages) < 2:
                continue
            link.group_of(stages)
            layer = self._shared_layers.get(key)
            if layer is None:
                continue
            desc = next(d for d in self.descs if isinstance(
                d, SharedLayerDesc) and d.layer_name == key)
            p = getattr(layer, desc.shared_weight_attr)
            _pipe.mark_shared(p, stages, owner=self._stage_id == stages[0])
            params.append(p)
        _pipe.broadcast_shared_weights(params, link)

    def _partition(self, n, stages) -> List[int]:
        """Return stage id per layer index."""
        if self._seg_method.startswith("layer:"):
            name = self._seg_method.split(":", 1)[1]
            marks = [i for i, d in enumerate(self.descs)
                     if _type_name(d) == name]
            if len(marks) >= stages:
                per = len(marks) // stages
                bounds = [marks[i * per] for i in range(stages)] + [n]
                bounds[0] = 0
            else:
                bounds = np.linspace(0, n, stages + 1).astype(int).tolist()
        else:
            bounds = np.linspace(0, n, stages + 1).astype(int).tolist()
        seg = []
        for i in range(n):
            for s in range(stages):
                if bounds[s] <= i < bounds[s + 1]:
                    seg.append(s)
                    break
        return seg

    def _chunk_of(self, i):
        return self._segments[i] // self._num_stages

    def get_stage_layers(self, stage_id):
        """The built (layer, forward_func) entries of `stage_id` (every
        chunk of it). At pp > 1 a rank builds only its own stage."""
        if self._split and stage_id != self._stage_id:
            raise ValueError(
                f"PipelineLayer: stage {stage_id} is built on its own rank; "
                f"this rank holds stage {self._stage_id}")
        S = self._num_stages
        return [e for i, e in zip(self._held, self.run_function)
                if self._segments[i] % S == stage_id]

    def forward(self, x, chunk_id=None):
        """The entries this rank holds, in order (with `chunk_id`, only
        that chunk's): the whole model without a "pp" axis."""
        for i, (fn, fwd) in zip(self._held, self.run_function):
            if chunk_id is not None and self._chunk_of(i) != chunk_id:
                continue
            x = fwd(fn, x) if fwd is not None else fn(x)
        return x

    @property
    def parameters_by_stage(self):
        out = {}
        for i, (l, _) in zip(self._held, self.run_function):
            if isinstance(l, nn.Module):
                out.setdefault(self._segments[i] % self._num_stages,
                               []).extend(l.parameters())
        return out

    def chunk_fns(self):
        """This rank's chunk functions, for the schedules."""
        if list(self.buffers()):
            raise NotImplementedError(
                "PipelineLayer: layers with buffers (BatchNorm statistics) "
                "are not carried through the schedules yet (ROADMAP Queue 1 "
                "item 8 A)")
        if not self._split:
            return [self.forward]
        return [(lambda x, j=j: self.forward(x, chunk_id=j))
                for j in range(self._num_virtual)]
