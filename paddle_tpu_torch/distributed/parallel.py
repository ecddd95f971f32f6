"""`DataParallel` (counterpart of `paddle_tpu/distributed/parallel.py`).

The wrapped layers run as they are; `sync_gradients` (or
`apply_collective_grads`) averages every gradient over the mesh's `dp`
axis and does nothing when that axis is 1 (or there is no mesh), as the
reference's does. With `FLAGS_train_overlap` on (the default) the
gradients go in flat buckets, one all_reduce a bucket: reverse parameter
order (the order backward produces them), runs of one dtype, at most
`FLAGS_grad_bucket_mb` MiB each (<= 0: one parameter a bucket). The
bucket's members are its first synced step's; if the membership changes
(a gradient appears or goes, a shape or dtype changes), sync falls back
to one all_reduce a parameter for good. An all_reduce sums element by
element, so a bucket's elements get the same sums as lone parameters'
wherever the backend adds the ranks' values in the same order: always at
world 2 (a + b == b + a); at world 4 gloo's ring cuts a buffer into
pieces by its length, so a bucket's element may be summed in another
order than the same parameter's alone, one f32 rounding apart
(tests/test_torch_data_parallel.py). At construction, with dp > 1, each
parameter and buffer is broadcast from the axis's first rank, as Paddle's
DataParallel does.
"""
from __future__ import annotations

import contextlib

import torch
from torch import nn

from ..framework import config as _config
from . import collective as _collective
from . import env as _env
from . import mesh as _mesh


class DataParallel(nn.Module):
    def __init__(self, layers, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 group=None):
        super().__init__()
        self._layers = layers
        self._grad_sync_enabled = True
        self.find_unused_parameters = find_unused_parameters
        # the membership of the first synced step; a change moves sync to
        # the per-parameter reduce for good
        self._bucket_signature = None
        self._bucket_fallback = False
        if _mesh.axis_size("dp") > 1:
            self._broadcast_state()

    @torch.no_grad()
    def _broadcast_state(self):
        pg, _ = _collective._resolve("dp")
        src = _collective._global_rank(pg, 0)
        for t in list(self._layers.parameters()) + \
                list(self._layers.buffers()):
            _collective.broadcast(t, src=src, group="dp")

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    @contextlib.contextmanager
    def no_sync(self):
        prev = self._grad_sync_enabled
        self._grad_sync_enabled = False
        try:
            yield
        finally:
            self._grad_sync_enabled = prev

    @torch.no_grad()
    def sync_gradients(self):
        """Average every gradient over the dp axis (bucketed with
        FLAGS_train_overlap on, else one all_reduce a parameter)."""
        if not self._grad_sync_enabled or _mesh.axis_size("dp") <= 1:
            return
        params = list(self._layers.parameters())
        if (not _config.get_flag("FLAGS_train_overlap", True)
                or self._bucket_fallback):
            self._sync_per_param(params)
            return
        sig = _membership_signature(params)
        if self._bucket_signature is None:
            self._bucket_signature = sig
        elif sig != self._bucket_signature:
            self._bucket_fallback = True
            self._sync_per_param(params)
            return
        for bucket in _bucket_grads(
                [p for p in params if p.grad is not None]):
            _reduce_bucket(bucket)

    def _sync_per_param(self, params):
        for p in params:
            if p.grad is not None:
                _collective.all_reduce(p.grad, op=_collective.ReduceOp.AVG,
                                       group="dp")

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, state_dict, *args, **kwargs):
        return self._layers.load_state_dict(state_dict, *args, **kwargs)

    load_state_dict = set_state_dict

    def scale_loss(self, loss):
        return loss

    def apply_collective_grads(self):
        self.sync_gradients()


def _membership_signature(params):
    """The bucketed reducer's stability key: each parameter's position,
    shape, dtype and whether it has a gradient."""
    return tuple((i, tuple(p.shape), p.dtype, p.grad is not None)
                 for i, p in enumerate(params))


def _bucket_grads(params):
    """The gradient-bearing `params` in buckets: reverse order, runs of
    one gradient dtype, at most FLAGS_grad_bucket_mb MiB each."""
    cap = int(_config.get_flag("FLAGS_grad_bucket_mb", 25)) << 20
    buckets, cur, cur_bytes, cur_dtype = [], [], 0, None
    for p in reversed(params):
        g = p.grad
        nbytes = g.numel() * g.element_size()
        if cur and (g.dtype != cur_dtype or cur_bytes + nbytes > cap):
            buckets.append(cur)
            cur, cur_bytes = [], 0
        cur.append(p)
        cur_bytes += nbytes
        cur_dtype = g.dtype
    if cur:
        buckets.append(cur)
    return buckets


def _reduce_bucket(bucket):
    """One all_reduce (AVG over dp) for the whole bucket: the gradients
    flattened into one buffer, reduced, and copied back."""
    if len(bucket) == 1:
        _collective.all_reduce(bucket[0].grad, op=_collective.ReduceOp.AVG,
                               group="dp")
        return
    flat = torch.cat([p.grad.reshape(-1) for p in bucket])
    _collective.all_reduce(flat, op=_collective.ReduceOp.AVG, group="dp")
    off = 0
    for p in bucket:
        n = p.grad.numel()
        p.grad.copy_(flat[off:off + n].view_as(p.grad))
        off += n


def init_parallel_env():
    _env.init_parallel_env()


def get_rank(group=None):
    return _env.get_rank()


def get_world_size(group=None):
    return _env.get_world_size()
