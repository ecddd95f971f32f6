"""Weight-only quantized linears (counterpart of `paddle_tpu/nn/quant`).

    quantize_for_inference(model, algo="weight_only_int8",
                           exclude=("lm_head",))

swaps every `Linear` of a model (`ColumnParallelLinear` and
`RowParallelLinear` are `Linear`s) for a `WeightOnlyLinear` holding int8
(or nibble-packed int4) weights and f32 scales, per output channel or per
group of 64 or 128 input rows. The layouts and the quantization are the
reference's (`weight_quantize`: symmetric absmax, round half to even), and
the values are bit-identical to its numpy code. Quantization runs on the
weight's own device, one linear at a time, so a model's float weights are
freed as it goes and a large model never passes through host memory.

A tensor-parallel shard (a `ColumnParallelLinear` or `RowParallelLinear`
at degree > 1) is quantized as the whole weight would be, and the rank
keeps its slice: the reference's "same int8 lattice; GSPMD only changes
the layout". A column shard owns whole output columns, so its scales are
local. A row shard owns a slice of the input rows: a per-channel scale is
the column's absmax over the whole k, all_reduced (MAX) over the group
before the rank quantizes; groups must lie whole inside the rank's rows
(k / tp a multiple of the group size; int4: k / tp even). The quantized
layer keeps the source's shard contract: a column shard's output stays the
rank's columns (or is gathered, with `gather_output`); a row shard takes
the rank's slice of its input (split first without `input_is_parallel`),
all_reduces the partial products, then adds its replicated bias once.

The products run through `kernels.quant_matmul` (the CUDA dequant-matmul on
the GPU). `algo="llm.int8"` (the reference's int8 x int8 decomposition, XLA
code rather than a TPU kernel) is not ported: the layers raise
`NotImplementedError` for it.
"""
from __future__ import annotations

import torch
from torch import nn

from ...framework.device import torch_dtype
from ...kernels.quant_matmul import dequantize, quant_matmul
from ..layers import Linear
__all__ = ["weight_quantize", "weight_dequantize", "weight_only_linear",
           "WeightOnlyLinear", "quantize_for_inference"]

_ALGOS = ("weight_only_int8", "weight_only_int4", "llm.int8")


def _check_algo(algo, layer=False):
    if algo not in _ALGOS:
        raise ValueError(f"unsupported quantization algo {algo!r}; take one "
                         f"of {_ALGOS}")
    if layer and algo == "llm.int8":
        raise NotImplementedError(
            "algo='llm.int8' (llm_int8_linear) is not ported; use "
            "'weight_only_int8' or 'weight_only_int4'")


def _group_shape(k, group_size):
    if group_size == -1:
        return 1, k
    if group_size not in (64, 128):
        raise ValueError("group_size must be -1 (per-channel), 64 or 128")
    if k % group_size:
        raise ValueError(f"in_features {k} not divisible by group_size "
                         f"{group_size}")
    return k // group_size, group_size


def _weight_dtype(algo):
    return "int4" if algo == "weight_only_int4" else "int8"


def weight_quantize(x, algo="weight_only_int8", arch=None, group_size=-1):
    """Quantize a [in_features, out_features] float weight on its device.

    Returns `(quant_weight, scale)`: int8 [k, n] (int4: [k // 2, n], two
    rows to a byte, low nibble = even row) and f32 scales [n]
    (group_size -1) or [k // group_size, n]. Symmetric absmax over each
    group in f32: scale = max(absmax / qmax, tiny), q = clip(round(w /
    scale), -qmax, qmax) with qmax 127 (int8) or 7 (int4). `arch` is
    accepted for signature parity and ignored."""
    return _quantize(x, algo, group_size)


@torch.no_grad()
def _quantize(x, algo, group_size, absmax_group=None):
    """`weight_quantize`; with `absmax_group` (a row shard's tensor-parallel
    group) the [groups, n] absmax is all_reduced MAX over it before the
    scales are taken."""
    _check_algo(algo)
    w = x.detach().to(torch.float32)
    if w.dim() != 2:
        raise ValueError(f"weight must be 2-D [in, out], got "
                         f"{tuple(w.shape)}")
    k, n = w.shape
    bits = 4 if algo == "weight_only_int4" else 8
    qmax = (1 << (bits - 1)) - 1
    groups, gsz = _group_shape(k, group_size)
    wg = w.reshape(groups, gsz, n)
    absmax = wg.abs().amax(dim=1)  # [groups, n]
    if absmax_group is not None:
        from ...distributed import collective as _collective

        _collective.all_reduce(absmax, op=_collective.ReduceOp.MAX,
                               group=absmax_group)
    scale = absmax / qmax
    scale = scale.clamp_min(torch.finfo(torch.float32).tiny)
    q = torch.round(wg / scale[:, None, :]).clamp_(-qmax, qmax)
    q = q.reshape(k, n).to(torch.int8)
    if bits == 4:
        if k % 2:
            raise ValueError("int4 packing needs an even in_features")
        lo = q[0::2].to(torch.int32) & 0xF
        hi = q[1::2].to(torch.int32) & 0xF
        u = lo | (hi << 4)  # the byte, 0..255
        q = torch.where(u >= 128, u - 256, u).to(torch.int8)
    if group_size == -1:
        scale = scale[0]
    return q, scale


def weight_dequantize(x, scale, algo="weight_only_int8", group_size=-1,
                      out_dtype="float32"):
    """The exact inverse layout of `weight_quantize`: the [k, n] weight in
    `out_dtype`."""
    _check_algo(algo)
    return dequantize(x, scale, _weight_dtype(algo), torch_dtype(out_dtype))


def weight_only_linear(x, weight, bias=None, weight_scale=None,
                       weight_dtype="int8", arch=None, group_size=-1):
    """y = x @ dequant(weight) + bias through `kernels.quant_matmul`: the
    CUDA kernel for CUDA tensors (it launches or raises), the plain
    version for CPU tensors."""
    if weight_dtype not in ("int8", "int4"):
        raise ValueError("weight_dtype must be 'int8' or 'int4'")
    if weight_scale is None:
        raise ValueError("weight_scale is required")
    out = quant_matmul(x, weight, weight_scale, weight_dtype, group_size)
    return out if bias is None else out + bias


class WeightOnlyLinear(nn.Module):
    """Inference linear over quantized storage: buffers `quant_weight` (int8
    [k, n], int4 [k // 2, n]) and `weight_scale` (f32 [n] or [groups, n]),
    an optional bias, as `quantize_for_inference` makes them from a
    `Linear`."""

    def __init__(self, in_features, out_features, algo="weight_only_int8",
                 group_size=-1, name=None, device=None):
        super().__init__()
        _check_algo(algo, layer=True)
        groups, _ = _group_shape(in_features, group_size)
        self._in_features = in_features
        self._out_features = out_features
        self._algo = algo
        self._weight_dtype = _weight_dtype(algo)
        self._group_size = group_size
        rows = in_features // 2 if self._weight_dtype == "int4" \
            else in_features
        sshape = (out_features,) if group_size == -1 \
            else (groups, out_features)
        self.register_buffer("quant_weight", torch.zeros(
            rows, out_features, dtype=torch.int8, device=device))
        self.register_buffer("weight_scale", torch.zeros(
            sshape, dtype=torch.float32, device=device))
        self.bias = None
        # a tensor-parallel shard's contract: None, or (kind, group, flag):
        # ("column", group, gather_output), ("row", group,
        # input_is_parallel)
        self._shard = None

    @classmethod
    def from_source(cls, layer, algo="weight_only_int8", group_size=-1):
        """Quantize a float `Linear` ([in, out] weight) into a new layer on
        the same device. A tensor-parallel shard is quantized as the whole
        weight would be and keeps its slice and its shard contract (the
        module docstring)."""
        shard = _shard_of(layer)
        w = layer.weight
        k, n = w.shape
        absmax_group = None
        if shard is not None and shard[0] == "row":
            _check_row_shard(layer, k, algo, group_size)
            if group_size == -1:
                absmax_group = shard[1]
        obj = cls(k, n, algo=algo, group_size=group_size, device="meta")
        qw, scale = _quantize(w, algo, group_size, absmax_group)
        obj.quant_weight = qw
        obj.weight_scale = scale
        obj.bias = getattr(layer, "bias", None)
        obj._shard = shard
        obj.eval()
        return obj

    def forward(self, x):
        if self._shard is None:
            return weight_only_linear(x, self.quant_weight, self.bias,
                                      self.weight_scale, self._weight_dtype,
                                      group_size=self._group_size)
        from ...distributed.fleet.layers.mpu import mp_layers as _mp

        kind, group, flag = self._shard
        if kind == "column":
            out = weight_only_linear(
                _mp._c_identity(x, group), self.quant_weight, self.bias,
                self.weight_scale, self._weight_dtype,
                group_size=self._group_size)
            return _mp._c_concat(out, group) if flag else out
        if not flag:
            x = _mp._c_split(x, group)
        out = _mp._mp_allreduce(weight_only_linear(
            x, self.quant_weight, None, self.weight_scale,
            self._weight_dtype, group_size=self._group_size), group)
        return out if self.bias is None else out + self.bias

    def extra_repr(self):
        return (f"in_features={self._in_features}, "
                f"out_features={self._out_features}, algo={self._algo}, "
                f"group_size={self._group_size}")


def _shard_of(layer):
    """The shard contract of a tensor-parallel linear at degree > 1 (see
    `WeightOnlyLinear._shard`), or None. The sequence-parallel linears run
    the training forward only and raise."""
    if getattr(layer, "world_size", 1) <= 1:
        return None
    from ...distributed.fleet.layers.mpu.mp_layers import (
        ColumnParallelLinear, RowParallelLinear)

    if type(layer) is ColumnParallelLinear:
        return "column", layer._group, bool(layer.gather_output)
    if type(layer) is RowParallelLinear:
        return "row", layer._group, bool(layer.input_is_parallel)
    raise NotImplementedError(
        f"WeightOnlyLinear.from_source: a {type(layer).__name__} shard: "
        "sequence-parallel linears run the training forward only; build "
        "the model without config.sequence_parallel to serve it")


def _check_row_shard(layer, k, algo, group_size):
    """A row shard's k rows must hold whole groups (and, for int4, whole
    bytes of two rows): a group across two ranks would need scales the
    rank cannot form alone."""
    what = (f"a RowParallelLinear shard of in_features {k} (of "
            f"{layer.in_features}, tensor-parallel degree "
            f"{layer.world_size})")
    if group_size != -1 and k % group_size:
        raise ValueError(f"{what} is not a whole number of groups of "
                         f"{group_size}: a group would straddle two ranks")
    if algo == "weight_only_int4" and k % 2:
        raise ValueError(f"{what}: int4 packs two rows a byte and needs "
                         f"an even shard")


def quantize_for_inference(model, algo="weight_only_int8", group_size=-1,
                           exclude=()):
    """Swap every `Linear` sublayer for a `WeightOnlyLinear` (in place;
    returns the model). `exclude` names sublayers (attribute name or dotted
    path) to keep in float, e.g. `("lm_head",)`. The walk replaces one
    linear at a time, so each float weight is freed once its quantized copy
    exists."""
    _check_algo(algo, layer=True)

    def walk(parent, prefix):
        for name in list(parent._modules):
            child = parent._modules[name]
            full = f"{prefix}.{name}" if prefix else name
            if isinstance(child, Linear) and child.weight.dim() == 2:
                if full in exclude or name in exclude:
                    continue
                # the last reference to the float layer goes with `child`
                setattr(parent, name,
                        WeightOnlyLinear.from_source(child, algo, group_size))
                del child
            elif child is not None:
                walk(child, full)

    walk(model, "")
    return model
