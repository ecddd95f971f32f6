"""The pipeline's point-to-point transfers (Paddle's
`fleet/meta_parallel/pp_utils/p2p_communication.py`; the JAX package has no
counterpart: its stages exchange by `ppermute` inside one compiled
program).

A `P2PLink` is one rank's view of its "pp" group: the previous and next
stage's global ranks (Paddle's `_get_p2p_prev_rank` / `_get_p2p_next_rank`,
wrapping around the ring as the interleaved schedule needs) and two process
groups over the same ranks. Activations travel forward over the mesh's "pp"
group and cotangents backward over a second group, so the two kinds never
share a channel: with two stages both travel between the same two ranks in
both directions, and a backend matches the messages of one channel in the
order they were posted. Every op is an `isend` or `irecv` started through
`batch_isend_irecv`. A send is not waited for until `finish` (the end of a
step), so a rank blocks only where it receives, and a schedule whose order
is valid cannot deadlock.

The shape and dtype of a transfer are the caller's, fixed by the model's
config and the microbatch; `send_meta` / `recv_meta` carry them once where
they are not known (a `PipelineLayer` of arbitrary layers).

Backends: over NCCL the device tensors go as they are. Over gloo (the
backend a caller names to put several ranks on one card) a CUDA tensor is
staged through a pinned host buffer: copied to the host before its send,
received on the host and copied to the card after; `staged_bytes` counts
both. CPU tensors go over gloo as they are. The backend decides the route;
nothing catches an error to try another.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from .... import collective as _c
from .... import mesh as _mesh

# the dtypes a meta message can name, by code
_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.float64,
           torch.int64, torch.int32)
_META_LEN = 16


def subgroup(mesh, axis, members):
    """This rank's group of the `axis` ranks at positions `members` (the
    same positions in every row), or None where the rank is not among
    them. Collective: every rank of the default group calls it alike."""
    if list(members) == list(range(int(mesh[axis].size()))):
        return mesh[axis].get_group()
    rows = [[row[i] for i in members]
            for row in _mesh.axis_groups(mesh, axis)]
    group, _ = dist.new_subgroups_by_enumeration(rows)
    return group


class P2PLink:
    """This rank's links to its neighbouring stages over the mesh's
    "pp" axis; counts its sends, receives and staged bytes (`stats`,
    `reset_stats`)."""

    def __init__(self, mesh=None, axis="pp"):
        mesh = mesh or _mesh.get_mesh()
        self.mesh = mesh
        self.axis = axis
        self.num_stages = int(mesh[axis].size())
        self.stage = int(mesh.get_local_rank(axis))
        rows = _mesh.axis_groups(mesh, axis)
        me = dist.get_rank()
        self.ranks = next(r for r in rows if me in r)
        self.prev_rank = self.ranks[(self.stage - 1) % self.num_stages]
        self.next_rank = self.ranks[(self.stage + 1) % self.num_stages]
        self.fwd_group = mesh[axis].get_group()
        self.bwd_group, _ = dist.new_subgroups_by_enumeration(rows)
        self.backend = dist.get_backend(self.fwd_group)
        self._groups = {}
        self._inflight = []
        self._free = {}
        self.reset_stats()

    # ------------------------------------------------------------------
    def group_of(self, stages):
        """The group of this link's ranks at `stages` (cached; collective
        the first time: every rank asks for the same stages in the same
        order)."""
        key = tuple(sorted(stages))
        if key not in self._groups:
            self._groups[key] = subgroup(self.mesh, self.axis, key)
        return self._groups[key]

    def reset_stats(self):
        self.sends = self.recvs = 0
        self.sent_bytes = self.staged_bytes = 0

    def stats(self):
        return dict(sends=self.sends, recvs=self.recvs,
                    sent_bytes=self.sent_bytes,
                    staged_bytes=self.staged_bytes)

    def _staged(self, device):
        return device.type == "cuda" and self.backend == "gloo"

    def _host(self, shape, dtype):
        free = self._free.setdefault((tuple(shape), dtype), [])
        return free.pop() if free else torch.empty(
            shape, dtype=dtype, pin_memory=True)

    def _release(self, buf):
        self._free.setdefault((tuple(buf.shape), buf.dtype), []).append(buf)

    # ------------------------------------------------------------------
    def _send(self, tensor, peer, group):
        t = tensor.detach().contiguous()
        nbytes = t.numel() * t.element_size()
        buf, staged = t, self._staged(t.device)
        if staged:
            buf = self._host(t.shape, t.dtype)
            buf.copy_(t)
            self.staged_bytes += nbytes
        works = _c.batch_isend_irecv([_c.P2POp(_c.isend, buf, peer, group)])
        self._inflight.append((works, buf if staged else None, t))
        self.sends += 1
        self.sent_bytes += nbytes

    def _recv(self, shape, dtype, device, peer, group):
        device = torch.device(device)
        staged = self._staged(device)
        buf = self._host(shape, dtype) if staged else \
            torch.empty(shape, dtype=dtype, device=device)
        for w in _c.batch_isend_irecv([_c.P2POp(_c.irecv, buf, peer,
                                                group)]):
            w.wait()
        self.recvs += 1
        if not staged:
            return buf
        out = buf.to(device)
        self.staged_bytes += buf.numel() * buf.element_size()
        self._release(buf)
        return out

    def finish(self):
        """Wait for every send still in flight (the end of a step)."""
        for works, buf, _ in self._inflight:
            for w in works:
                w.wait()
            if buf is not None:
                self._release(buf)
        self._inflight = []

    # ------------------------------------------------------------------
    def send_forward(self, output_tensor):
        self._send(output_tensor, self.next_rank, self.fwd_group)

    def recv_forward(self, shape, dtype, device):
        return self._recv(shape, dtype, device, self.prev_rank,
                          self.fwd_group)

    def send_backward(self, input_tensor_grad):
        self._send(input_tensor_grad, self.prev_rank, self.bwd_group)

    def recv_backward(self, shape, dtype, device):
        return self._recv(shape, dtype, device, self.next_rank,
                          self.bwd_group)

    def _meta_device(self):
        return torch.device("cpu") if self.backend == "gloo" else \
            torch.device("cuda", torch.cuda.current_device())

    def send_meta(self, tensor):
        """The shape and dtype of `tensor` to the next stage, ahead of the
        first activation of that kind."""
        meta = [tensor.ndim, *tensor.shape, _DTYPES.index(tensor.dtype)]
        m = torch.zeros(_META_LEN, dtype=torch.int64)
        m[:len(meta)] = torch.tensor(meta)
        self._send(m.to(self._meta_device()), self.next_rank, self.fwd_group)

    def recv_meta(self):
        """(shape, dtype) the previous stage's `send_meta` announced."""
        m = self._recv((_META_LEN,), torch.int64, self._meta_device(),
                       self.prev_rank, self.fwd_group).tolist()
        nd = int(m[0])
        return tuple(int(v) for v in m[1:1 + nd]), _DTYPES[int(m[1 + nd])]


_links = {}


def link_for(mesh=None, axis="pp"):
    """The `P2PLink` of `mesh` (default: the global mesh), made once
    (collective the first time: every rank calls it alike)."""
    mesh = mesh or _mesh.get_mesh()
    key = (id(mesh), axis)
    if key not in _links or _links[key][0] is not mesh:
        _links[key] = (mesh, P2PLink(mesh, axis))
    return _links[key][1]


def _link(link):
    return link if link is not None else link_for()


def send_forward(output_tensor, link=None):
    """`output_tensor` to the next stage (not waited for)."""
    _link(link).send_forward(output_tensor)


def recv_forward(shape, dtype, device=None, link=None):
    """The previous stage's activation, [shape] of `dtype` on `device`
    (default: this rank's device)."""
    from .... import env as _env

    return _link(link).recv_forward(
        shape, dtype, device or _env.device() or torch.device("cpu"))


def send_backward(input_tensor_grad, link=None):
    """The cotangent of this stage's input to the previous stage."""
    _link(link).send_backward(input_tensor_grad)


def recv_backward(shape, dtype, device=None, link=None):
    """The next stage's cotangent of this stage's output."""
    from .... import env as _env

    return _link(link).recv_backward(
        shape, dtype, device or _env.device() or torch.device("cpu"))


def send_forward_recv_backward(output_tensor, link=None):
    """`output_tensor` to the next stage, then the next stage's cotangent
    of it (same shape and dtype)."""
    lk = _link(link)
    lk.send_forward(output_tensor)
    return lk.recv_backward(output_tensor.shape, output_tensor.dtype,
                            output_tensor.device)


def send_backward_recv_forward(input_tensor_grad, link=None):
    """The cotangent of this stage's input to the previous stage, then the
    previous stage's next activation (of the input's shape and dtype)."""
    lk = _link(link)
    lk.send_backward(input_tensor_grad)
    return lk.recv_forward(input_tensor_grad.shape, input_tensor_grad.dtype,
                           input_tensor_grad.device)
