"""Shape and layout ops (counterpart of `paddle_tpu/ops/manipulation.py`):
reshape, transpose, concat, split, stack, squeeze, unsqueeze, flatten,
tile, expand, flip, roll, gather, scatter, index_select, chunk, pad,
unbind, take_along_axis, put_along_axis, repeat_interleave, ...

Paddle's meanings where torch's differ: `split` takes a number of sections
or the section sizes with one -1; `gather` selects along `axis`;
`scatter(overwrite=False)` zeroes the target rows, then sums the updates
into them; `transpose` takes a full permutation; `expand`'s -1 keeps a
size; `flatten` flattens `start_axis` to `stop_axis`.
"""
from __future__ import annotations

import builtins
import itertools

import numpy as np
import torch

from ..framework import dtype as _dtype
from ..tensor import Tensor, apply_op, as_array  # noqa: F401


def _int_list(v):
    if isinstance(v, torch.Tensor):
        v = v.tolist()
    if isinstance(v, (int, np.integer)):
        return int(v)
    return [int(i) if not isinstance(i, torch.Tensor) else int(i.item())
            for i in v]


def _as_list(v):
    v = _int_list(v)
    return [v] if isinstance(v, int) else v


def _axis_int(axis):
    return int(axis.item()) if isinstance(axis, torch.Tensor) else int(axis)


def reshape(x, shape, name=None):
    shape = _int_list(shape)
    return apply_op(lambda a: torch.reshape(a, shape), x, _name="reshape")


def reshape_(x, shape, name=None):
    from .inplace import _rebind

    return _rebind(x, reshape, shape, _name="reshape_")


def view(x, shape_or_dtype, name=None):
    if isinstance(shape_or_dtype, (list, tuple)):
        return reshape(x, shape_or_dtype)
    return as_array(x).view(_dtype.to_torch_dtype(shape_or_dtype))


def view_as(x, other, name=None):
    return reshape(x, list(other.shape))


def transpose(x, perm, name=None):
    perm = _int_list(perm)
    return apply_op(lambda a: a.permute(*perm), x, _name="transpose")


def t(x, name=None):
    def f(a):
        if a.dim() < 2:
            return a
        if a.dim() == 2:
            return a.t()
        raise ValueError("paddle.t only supports ndim<=2; use transpose")

    return apply_op(f, x, _name="t")


def moveaxis(x, source, destination, name=None):
    return apply_op(lambda a: torch.movedim(a, _int_list(source),
                                            _int_list(destination)),
                    x, _name="moveaxis")


def swapaxes(x, axis0, axis1, name=None):
    return apply_op(lambda a: torch.swapaxes(a, int(axis0), int(axis1)), x,
                    _name="swapaxes")


transpose_ = transpose


def concat(x, axis=0, name=None):
    ax = _axis_int(axis)
    return apply_op(lambda *arrs: torch.cat(arrs, ax), *list(x),
                    _name="concat")


def stack(x, axis=0, name=None):
    return apply_op(lambda *arrs: torch.stack(arrs, int(axis)), *list(x),
                    _name="stack")


def hstack(x, name=None):
    return apply_op(lambda *arrs: torch.hstack(arrs), *list(x),
                    _name="hstack")


def vstack(x, name=None):
    return apply_op(lambda *arrs: torch.vstack(arrs), *list(x),
                    _name="vstack")


def dstack(x, name=None):
    return apply_op(lambda *arrs: torch.dstack(arrs), *list(x),
                    _name="dstack")


def column_stack(x, name=None):
    """1-D inputs become columns (paddle.column_stack)."""
    return apply_op(lambda *arrs: torch.column_stack(arrs), *list(x),
                    _name="column_stack")


def row_stack(x, name=None):
    """vstack's alias (paddle.row_stack)."""
    return apply_op(lambda *arrs: torch.vstack(arrs), *list(x),
                    _name="row_stack")


def block_diag(inputs, name=None):
    """A block-diagonal matrix from 2-D inputs (paddle.block_diag)."""
    tensors = [t if t.dim() >= 2 else reshape(
        t, [1, -1] if t.dim() == 1 else [1, 1])
        for t in (inputs if isinstance(inputs, (list, tuple))
                  else [inputs])]
    return apply_op(lambda *arrs: torch.block_diag(*arrs), *tensors,
                    _name="block_diag")


def slice_scatter(x, value, axes, starts, ends, strides=None, name=None):
    """`value` written into the slice of `x` that axes / starts / ends /
    strides describe; a new tensor."""
    axes, starts, ends = _as_list(axes), _as_list(starts), _as_list(ends)
    strides = _as_list(strides) if strides is not None else [1] * len(axes)

    def impl(a, v):
        idx = [builtins.slice(None)] * a.dim()
        for ax, st, en, sd in zip(axes, starts, ends, strides):
            idx[ax] = builtins.slice(st, en, sd)
        out = a.clone()
        out[tuple(idx)] = v.to(a.dtype)
        return out

    return apply_op(impl, x, value, _name="slice_scatter")


def diagonal_scatter(x, y, offset=0, axis1=0, axis2=1, name=None):
    """`y` written onto the diagonal of `x` that offset / axis1 / axis2
    select (the diagonal is `y`'s last axis)."""
    return apply_op(lambda a, v: torch.diagonal_scatter(
        a, v.to(a.dtype), int(offset), int(axis1), int(axis2)), x, y,
        _name="diagonal_scatter")


def fill_diagonal(x, value, offset=0, wrap=False, name=None):
    """The source of `fill_diagonal_`: the main diagonal of a 2-D tensor
    (with numpy's wrap for tall ones), or the [i, i, ..., i] hyperdiagonal
    of more dims, set to `value`."""
    offset = int(offset)

    def impl(a):
        out = a.clone()
        if a.dim() == 2:
            nr, nc = a.shape
            if wrap and offset == 0 and nr > nc:
                flat = torch.arange(0, nr * nc, nc + 1, device=a.device)
                out[flat // nc, flat % nc] = value
                return out
            n = builtins.max(builtins.min(nr, nc - offset) if offset >= 0
                             else builtins.min(nr + offset, nc), 0)
            i = torch.arange(n, device=a.device)
            r, c = (i, i + offset) if offset >= 0 else (i - offset, i)
            out[r, c] = value
            return out
        i = torch.arange(builtins.min(a.shape), device=a.device)
        out[tuple([i] * a.dim())] = value
        return out

    return apply_op(impl, x, _name="fill_diagonal")


def apply(x, func, name=None):
    """The source of `Tensor.apply_`: `func(x)`."""
    return func(x)


def shape(x, name=None):
    """The shape as an int32 tensor on x's device (paddle.shape)."""
    a = as_array(x)
    return torch.tensor(list(a.shape), dtype=torch.int32, device=a.device)


def combinations(x, r=2, with_replacement=False, name=None):
    """The r-length combinations of a 1-D tensor's elements."""
    n = as_array(x).shape[0]
    gen = itertools.combinations_with_replacement(range(n), int(r)) \
        if with_replacement else itertools.combinations(range(n), int(r))
    idx = np.asarray(list(gen), dtype=np.int64).reshape(-1, int(r))
    return apply_op(lambda a: a[torch.from_numpy(idx).to(a.device)], x,
                    _name="combinations")


def cartesian_prod(x, name=None):
    """The cartesian product of 1-D tensors, [prod(len_i), k] rows in
    odometer order; a single input stays 1-D."""
    xs = list(x) if isinstance(x, (list, tuple)) else [x]
    if builtins.any(as_array(t).dim() != 1 for t in xs):
        raise ValueError("cartesian_prod expects 1-D tensors")

    def _prod(*arrs):
        if len(arrs) == 1:
            return arrs[0]
        grids = torch.meshgrid(*arrs, indexing="ij")
        return torch.stack([g.reshape(-1) for g in grids], -1)

    return apply_op(_prod, *xs, _name="cartesian_prod")


def split(x, num_or_sections, axis=0, name=None):
    """A list of pieces along `axis`: `num_or_sections` equal ones (the
    size must divide), or pieces of the sizes given, one of them -1 (what
    is left)."""
    axis = _axis_int(axis)
    dim = as_array(x).shape[axis]
    if isinstance(num_or_sections, int):
        if dim % num_or_sections != 0:
            raise ValueError(
                f"split: dimension {dim} on axis {axis} is not divisible by "
                f"num {num_or_sections}")
        sections = [dim // num_or_sections] * num_or_sections
    else:
        sections = _as_list(num_or_sections)
        if -1 in sections:
            known = builtins_sum(s for s in sections if s != -1)
            sections = [dim - known if s == -1 else s for s in sections]
    return list(apply_op(lambda a: torch.split(a, sections, axis), x,
                         _name="split"))


def builtins_sum(it):
    return builtins.sum(it)


def chunk(x, chunks, axis=0, name=None):
    """split's pieces, the last one short where the size does not divide
    (paddle.chunk)."""
    chunks = int(chunks)
    dim = as_array(x).shape[_axis_int(axis)]
    if dim % chunks == 0:
        return split(x, chunks, axis=axis)
    per = -(-dim // chunks)
    sections = [per] * (dim // per) + ([dim % per] if dim % per else [])
    return split(x, sections, axis=axis)


def tensor_split(x, num_or_indices, axis=0, name=None):
    n = as_array(x).shape[int(axis)]
    if isinstance(num_or_indices, int):
        sections = [len(p) for p in np.array_split(np.arange(n),
                                                    num_or_indices)]
        return split(x, sections, axis=axis)
    sections, prev = [], 0
    for i in _as_list(num_or_indices):
        sections.append(i - prev)
        prev = i
    sections.append(n - prev)
    return split(x, sections, axis=axis)


def unbind(x, axis=0, name=None):
    return list(apply_op(lambda a: torch.unbind(a, int(axis)), x,
                         _name="unbind"))


def unstack(x, axis=0, num=None, name=None):
    return unbind(x, axis)


def squeeze(x, axis=None, name=None):
    def f(a):
        if axis is None:
            return torch.squeeze(a)
        axes = [ax % a.dim() for ax in _as_list(axis)]
        axes = [ax for ax in axes if a.shape[ax] == 1]
        return torch.squeeze(a, tuple(axes)) if axes else a

    return apply_op(f, x, _name="squeeze")


squeeze_ = squeeze


def unsqueeze(x, axis, name=None):
    axes = _as_list(axis)

    def f(a):
        out = a
        for ax in sorted(axes):
            out = torch.unsqueeze(out, ax)
        return out

    return apply_op(f, x, _name="unsqueeze")


unsqueeze_ = unsqueeze


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    def f(a):
        if a.dim() == 0:
            return a.reshape(1)
        return torch.flatten(a, start_axis % a.dim(), stop_axis % a.dim())

    return apply_op(f, x, _name="flatten")


def tile(x, repeat_times, name=None):
    reps = _as_list(repeat_times)
    return apply_op(lambda a: torch.tile(a, reps), x, _name="tile")


def expand(x, shape, name=None):
    """x broadcast to `shape`; a -1 keeps that axis' size."""
    shape = _int_list(shape)

    def f(a):
        full = [1] * (len(shape) - a.dim()) + list(a.shape)
        out = [full[i] if shape[i] == -1 else shape[i]
               for i in range(len(shape))]
        return a.reshape(full).expand(out)

    return apply_op(f, x, _name="expand")


def expand_as(x, y, name=None):
    return expand(x, list(as_array(y).shape))


def broadcast_to(x, shape, name=None):
    shape = _int_list(shape)
    return apply_op(lambda a: torch.broadcast_to(a, shape), x,
                    _name="broadcast_to")


def broadcast_tensors(inputs, name=None):
    shape = np.broadcast_shapes(*[tuple(as_array(i).shape)
                                  for i in inputs])
    return [broadcast_to(i, list(shape)) for i in inputs]


def flip(x, axis, name=None):
    axes = _as_list(axis)
    return apply_op(lambda a: torch.flip(a, axes), x, _name="flip")


def fliplr(x, name=None):
    return apply_op(lambda a: torch.flip(a, [1]), x, _name="fliplr")


def flipud(x, name=None):
    return apply_op(lambda a: torch.flip(a, [0]), x, _name="flipud")


def roll(x, shifts, axis=None, name=None):
    sh = _int_list(shifts)
    ax = _int_list(axis) if axis is not None else None
    return apply_op(lambda a: torch.roll(a, sh, ax), x, _name="roll")


def gather(x, index, axis=0, name=None):
    """The slices of `x` at `index` (flattened) along `axis`."""
    ax = _axis_int(axis)
    return apply_op(lambda a, idx: torch.index_select(
        a, ax, idx.reshape(-1).long()), x, index, _name="gather")


def _nd_index(idx):
    return tuple(torch.movedim(idx.long(), -1, 0))


def gather_nd(x, index, name=None):
    return apply_op(lambda a, idx: a[_nd_index(idx)], x, index,
                    _name="gather_nd")


def scatter(x, index, updates, overwrite=True, name=None):
    """x with the rows at `index` (axis 0) replaced by `updates`'; with
    `overwrite=False` the rows at `index` are zeroed first and every
    update summed into its row."""
    def f(a, idx, upd):
        idx = idx.reshape(-1).long()
        if overwrite:
            out = a.clone()
            out[idx] = upd.to(a.dtype)
            return out
        zeroed = a.index_fill(0, idx, 0)
        return zeroed.index_add(0, idx, upd.to(a.dtype))

    return apply_op(f, x, index, updates, _name="scatter")


def scatter_(x, index, updates, overwrite=True, name=None):
    from .inplace import _rebind

    return _rebind(x, scatter, index, updates, overwrite,
                   _name="scatter_")


def scatter_nd_add(x, index, updates, name=None):
    def f(a, idx, upd):
        return a.index_put(_nd_index(idx), upd.to(a.dtype), accumulate=True)

    return apply_op(f, x, index, updates, _name="scatter_nd_add")


def scatter_nd(index, updates, shape, name=None):
    shape = _int_list(shape)

    def f(idx, upd):
        zeros = torch.zeros(shape, dtype=upd.dtype, device=upd.device)
        return zeros.index_put(_nd_index(idx), upd, accumulate=True)

    return apply_op(f, index, updates, _name="scatter_nd")


def index_select(x, index, axis=0, name=None):
    return apply_op(lambda a, idx: torch.index_select(
        a, int(axis), idx.reshape(-1).long()), x, index,
        _name="index_select")


def index_sample(x, index, name=None):
    return apply_op(lambda a, idx: torch.take_along_dim(a, idx.long(), 1),
                    x, index, _name="index_sample")


def index_add(x, index, axis, value, name=None):
    return apply_op(lambda a, idx, v: torch.index_add(
        a, int(axis), idx.reshape(-1).long(), v.to(a.dtype)), x, index,
        value, _name="index_add")


def index_put(x, indices, value, accumulate=False, name=None):
    def f(a, v, *idx):
        idx = tuple(i if i.dtype == torch.bool else i.long() for i in idx)
        return a.index_put(idx, v.to(a.dtype), accumulate=accumulate)

    return apply_op(f, x, value, *list(indices), _name="index_put")


def index_fill(x, index, axis, fill_value, name=None):
    return apply_op(lambda a, idx: torch.index_fill(
        a, int(axis), idx.reshape(-1).long(), fill_value), x, index,
        _name="index_fill")


def take_along_axis(arr, indices, axis, broadcast=True, name=None):
    return apply_op(lambda a, idx: torch.take_along_dim(
        a, idx.long(), int(axis)), arr, indices, _name="take_along_axis")


def put_along_axis(arr, indices, values, axis, reduce="assign", name=None):
    def f(a, idx, v):
        idx = idx.long()
        v = torch.broadcast_to(v, idx.shape).to(a.dtype)
        ax = int(axis) % a.dim()
        if reduce == "assign":
            return torch.scatter(a, ax, idx, v)
        if reduce in ("add", "sum"):
            return torch.scatter_add(a, ax, idx, v)
        if reduce in ("mul", "multiply"):
            return torch.scatter_reduce(a, ax, idx, v, "prod")
        raise ValueError(f"unknown reduce {reduce}")

    return apply_op(f, arr, indices, values, _name="put_along_axis")


def masked_select(x, mask, name=None):
    a, m = as_array(x), as_array(mask, as_array(x).device)
    return apply_op(lambda a_: a_[torch.broadcast_to(m, a_.shape)], a,
                    _name="masked_select")


def masked_fill(x, mask, value, name=None):
    if isinstance(value, torch.Tensor):
        return apply_op(lambda a, m, v: torch.where(m, v.to(a.dtype), a),
                        x, mask, value, _name="masked_fill")
    return apply_op(lambda a, m: a.masked_fill(m, value), x, mask,
                    _name="masked_fill")


def masked_scatter(x, mask, value, name=None):
    def f(a, m, v):
        m = torch.broadcast_to(m, a.shape)
        return a.masked_scatter(m, v.to(a.dtype).reshape(-1))

    return apply_op(f, x, mask, value, _name="masked_scatter")


def repeat_interleave(x, repeats, axis=None, name=None):
    ax = None if axis is None else int(axis)
    if isinstance(repeats, torch.Tensor):
        return apply_op(lambda a, r: torch.repeat_interleave(a, r, ax), x,
                        repeats, _name="repeat_interleave")
    return apply_op(lambda a: torch.repeat_interleave(a, int(repeats), ax),
                    x, _name="repeat_interleave")


def _pad_index(n, before, after, mode, device):
    """Source indices of an axis of size n padded by (before, after):
    numpy's "reflect", "edge" (replicate) and "wrap" (circular)."""
    i = torch.arange(-before, n + after, device=device)
    if mode == "replicate":
        return i.clamp(0, n - 1)
    if mode == "circular":
        return torch.remainder(i, n)
    if mode != "reflect":
        raise ValueError(f"unknown pad mode {mode}")
    period = builtins.max(2 * (n - 1), 1)
    i = torch.remainder(i.abs(), period)
    return torch.where(i >= n, period - i, i)


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    """Paddle's pad: `pad` of length 2 * ndim gives (before, after) of
    every axis from the first; a shorter one pads the trailing axes, the
    last axis first; a scalar pads every spatial axis on both sides."""
    pad_list = _int_list(pad)
    if isinstance(pad_list, int):
        n_spatial = builtins.max(len(data_format) - 2, 1)
        pad_list = [pad_list] * (2 * n_spatial)

    def f(a):
        nd = a.dim()
        if len(pad_list) == 2 * nd:
            widths = [(pad_list[2 * i], pad_list[2 * i + 1])
                      for i in range(nd)]
        else:
            widths = [(0, 0)] * nd
            for i in range(len(pad_list) // 2):
                widths[nd - 1 - i] = (pad_list[2 * i], pad_list[2 * i + 1])
        if mode == "constant":
            # torch's pad lists the last axis first
            flat = [w for ba in reversed(widths) for w in ba]
            return torch.nn.functional.pad(a, flat, value=value)
        for ax, (before, after) in enumerate(widths):
            if before or after:
                a = torch.index_select(a, ax, _pad_index(
                    a.shape[ax], before, after, mode, a.device))
        return a

    return apply_op(f, x, _name="pad")


def as_strided(x, shape, stride, offset=0, name=None):
    a = as_array(x)
    return torch.as_strided(a.contiguous(), list(shape), list(stride),
                            int(offset)).clone()


def slice(input, axes, starts, ends, name=None):
    axes, starts, ends = _as_list(axes), _as_list(starts), _as_list(ends)

    def f(a):
        idx = [builtins.slice(None)] * a.dim()
        for ax, s, e in zip(axes, starts, ends):
            dim = a.shape[ax]
            s2 = s + dim if s < 0 else builtins.min(s, dim)
            e2 = e + dim if e < 0 else builtins.min(e, dim)
            idx[ax] = builtins.slice(s2, e2)
        return a[tuple(idx)]

    return apply_op(f, input, _name="slice")


def strided_slice(x, axes, starts, ends, strides, name=None):
    axes, starts, ends = _as_list(axes), _as_list(starts), _as_list(ends)
    strides_l = _as_list(strides)

    def f(a):
        idx = [slice_builtin(None)] * a.dim()
        flips = []
        for ax, s, e, st in zip(axes, starts, ends, strides_l):
            if st < 0:  # torch slices take no negative step: flip
                n = a.shape[ax]
                rng = np.arange(n)[s:e:st]
                idx[ax] = torch.from_numpy(rng.copy()).to(a.device)
                flips.append(ax)
            else:
                idx[ax] = slice_builtin(s, e, st)
        out = a
        for ax in range(a.dim()):
            if isinstance(idx[ax], torch.Tensor):
                out = torch.index_select(out, ax, idx[ax])
                idx[ax] = slice_builtin(None)
        return out[tuple(idx)]

    return apply_op(f, x, _name="strided_slice")


def slice_builtin(*args):
    return builtins.slice(*args)


def crop(x, shape=None, offsets=None, name=None):
    shape = _as_list(shape)
    offsets = _as_list(offsets) if offsets is not None else [0] * len(shape)

    def f(a):
        return a[tuple(slice_builtin(o, o + (s if s != -1
                                             else a.shape[i] - o))
                       for i, (o, s) in enumerate(zip(offsets, shape)))]

    return apply_op(f, x, _name="crop")


def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, dtype="int64", name=None):
    """numpy's unique (sorted values; first indices, inverse, counts on
    request), computed on the host."""
    a = as_array(x)
    res = np.unique(a.detach().cpu().numpy(), return_index=return_index,
                    return_inverse=return_inverse,
                    return_counts=return_counts, axis=axis)
    if not isinstance(res, tuple):
        return torch.from_numpy(np.asarray(res)).to(a.device)
    return tuple(torch.from_numpy(np.asarray(r)).to(a.device) for r in res)


def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None, dtype="int64", name=None):
    a = as_array(x)
    out = torch.unique_consecutive(
        a.reshape(-1) if axis is None else a, return_inverse=return_inverse,
        return_counts=return_counts, dim=None if axis is None else axis)
    if isinstance(out, tuple):
        return tuple(out)
    return out


def rot90(x, k=1, axes=(0, 1), name=None):
    return apply_op(lambda a: torch.rot90(a, k, list(axes)), x,
                    _name="rot90")


def _atleast(fn, name, inputs):
    outs = [apply_op(fn, t, _name=name) for t in inputs]
    return outs[0] if len(outs) == 1 else outs


def atleast_1d(*inputs, name=None):
    return _atleast(torch.atleast_1d, "atleast_1d", inputs)


def atleast_2d(*inputs, name=None):
    return _atleast(torch.atleast_2d, "atleast_2d", inputs)


def atleast_3d(*inputs, name=None):
    return _atleast(torch.atleast_3d, "atleast_3d", inputs)


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    a = as_array(input)
    size = (index_num + nshards - 1) // nshards
    lo = shard_id * size
    return torch.where((a >= lo) & (a < lo + size), a - lo,
                       torch.full_like(a, ignore_value))


def hsplit(x, num_or_indices, name=None):
    """Split along axis 1 (axis 0 for 1-D); a list gives split indices,
    not sizes."""
    nd = as_array(x).dim()
    if nd < 1:
        raise ValueError("hsplit expects ndim >= 1")
    return tensor_split(x, num_or_indices, axis=1 if nd > 1 else 0)


def vsplit(x, num_or_indices, name=None):
    if as_array(x).dim() < 2:
        raise ValueError("vsplit expects ndim >= 2")
    return tensor_split(x, num_or_indices, axis=0)


def dsplit(x, num_or_indices, name=None):
    if as_array(x).dim() < 3:
        raise ValueError("dsplit expects ndim >= 3")
    return tensor_split(x, num_or_indices, axis=2)


def unflatten(x, axis, shape, name=None):
    """Axis `axis` expanded into `shape` (one -1 inferred)."""
    a_shape = list(as_array(x).shape)
    axis = int(axis) % len(a_shape)
    shape = [int(s.item()) if isinstance(s, torch.Tensor) else int(s)
             for s in shape]
    if shape.count(-1) == 1:
        known = int(np.prod([s for s in shape if s != -1]))
        shape[shape.index(-1)] = a_shape[axis] // known
    new_shape = a_shape[:axis] + shape + a_shape[axis + 1:]
    return apply_op(lambda a: torch.reshape(a, new_shape), x,
                    _name="unflatten")


def unfold(x, axis, size, step, name=None):
    """Windows of `size` every `step` along `axis`, as a new last axis."""
    return apply_op(lambda a: a.unfold(int(axis), int(size), int(step)), x,
                    _name="unfold")


def select_scatter(x, values, axis, index, name=None):
    """`values` written into x at `index` along `axis`."""
    idx = int(index.item()) if isinstance(index, torch.Tensor) else \
        int(index)
    return apply_op(lambda a, v: torch.select_scatter(
        a, v.to(a.dtype), int(axis), idx), x, values,
        _name="select_scatter")


def as_complex(x, name=None):
    """[..., 2] floats -> [...] complex."""
    return apply_op(lambda a: torch.complex(a[..., 0], a[..., 1]), x,
                    _name="as_complex")


def as_real(x, name=None):
    """[...] complex -> [..., 2] floats."""
    return apply_op(lambda a: torch.stack([a.real, a.imag], -1), x,
                    _name="as_real")


def tolist(x, name=None):
    return as_array(x).tolist()
