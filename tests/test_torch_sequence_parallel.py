"""The port's sequence parallelism against the JAX package's, on the CPU.

Two gloo ranks (`torch_tp_workers.sp_main`, `fleet.init` with mp_degree 2)
each take their half of the sequence of the same numpy input through a
`ColumnSequenceParallelLinear` (input all_gathered along the sequence),
gelu, a `RowSequenceParallelLinear` (output reduce_scattered along the
sequence, then its bias) and an RMSNorm whose weight is marked
sequence-parallel, with `register_sequence_parallel_allreduce_hooks`. The
reference runs the same layers full-size under a tp = 2 mesh, where GSPMD
reduces the gradients. Outputs and gradients, the ranks' shards joined,
match the reference within 1e-5 and the port's single-card layers within
1e-6 (f32); the gradients of the marked parameters (the norm's weight, the
row linear's bias) are equal on both ranks, bit for bit. The four ops
(`ScatterOp`, `GatherOp`, `AllGatherOp`, `ReduceScatterOp`) give the
reference's layouts.
"""
import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as TF

import paddle_tpu as paddle
import paddle_tpu.distributed.mesh as jmesh
from paddle_tpu.distributed.fleet.utils import sequence_parallel_utils as JSP
from paddle_tpu.nn import RMSNorm as JaxRMSNorm
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch.distributed.fleet import utils as TSP
from paddle_tpu_torch.nn import RMSNorm
from torch_dist_workers import run_group
from torch_tp_workers import IN, OUT, sp_main

SHAPE = (2, 6)  # batch, sequence (split over 2 ranks)
# the axis each result's shards join along (None: whole on every rank)
JOIN = dict(z=1, dx=1, dw=1, db=0, dw2=0, db2=None, dwn=None)


def _case():
    rng = np.random.RandomState(21)
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    return dict(w=f(IN, OUT), b=f(OUT), w2=f(OUT, IN), b2=f(IN),
                wn=1.0 + 0.1 * f(IN), x=f(*SHAPE, IN), g=f(*SHAPE, IN))


@pytest.fixture(scope="module")
def ranks():
    res = run_group(sp_main, 2, _case())
    return [r["sp"] for r in sorted(res, key=lambda r: r["tp_rank"])]


def _reference():
    c = _case()
    t = paddle.to_tensor
    jmesh.set_mesh(jmesh.build_mesh(
        tp=2, devices=np.asarray(jax.devices("cpu")[:2])))
    try:
        col = JSP.ColumnSequenceParallelLinear(IN, OUT, has_bias=True)
        row = JSP.RowSequenceParallelLinear(OUT, IN, has_bias=True)
        norm = JaxRMSNorm(IN)
        col.set_state_dict({"weight": t(c["w"]), "bias": t(c["b"])})
        row.set_state_dict({"weight": t(c["w2"]), "bias": t(c["b2"])})
        norm.set_state_dict({"weight": t(c["wn"])})
        x = paddle.to_tensor(c["x"], stop_gradient=False)
        z = norm(row(JF.gelu(col(x), approximate=True)))
        (z * t(c["g"])).sum().backward()
        out = dict(z=z, dx=x.grad, dw=col.weight.grad, db=col.bias.grad,
                   dw2=row.weight.grad, db2=row.bias.grad,
                   dwn=norm.weight.grad)
    finally:
        jmesh.set_mesh(None)
    return {k: np.asarray(v._data) for k, v in out.items()}


def _single_card():
    c = _case()
    col = TSP.ColumnSequenceParallelLinear(IN, OUT, has_bias=True,
                                           device="cpu")
    row = TSP.RowSequenceParallelLinear(OUT, IN, has_bias=True,
                                        device="cpu")
    norm = RMSNorm(IN, device="cpu")
    with torch.no_grad():
        for lay, w in ((col, c["w"]), (row, c["w2"]), (norm, c["wn"])):
            lay.weight.copy_(torch.from_numpy(w))
        col.bias.copy_(torch.from_numpy(c["b"]))
        row.bias.copy_(torch.from_numpy(c["b2"]))
    x = torch.tensor(c["x"], requires_grad=True)
    z = norm(row(TF.gelu(col(x), approximate="tanh")))
    (z * torch.from_numpy(c["g"])).sum().backward()
    return dict(z=z.detach().numpy(), dx=x.grad.numpy(),
                dw=col.weight.grad.numpy(), db=col.bias.grad.numpy(),
                dw2=row.weight.grad.numpy(), db2=row.bias.grad.numpy(),
                dwn=norm.weight.grad.numpy())


def _joined(ranks, key):
    parts = [r[key] for r in ranks]
    if JOIN[key] is None:
        np.testing.assert_array_equal(parts[1], parts[0], err_msg=key)
        return parts[0]
    return np.concatenate(parts, axis=JOIN[key])


@pytest.mark.parametrize("key", sorted(JOIN))
def test_sequence_parallel_pair_matches_the_reference_and_tp1(ranks, key):
    got = _joined(ranks, key)
    np.testing.assert_allclose(got, _reference()[key], rtol=1e-5, atol=1e-5,
                               err_msg=f"{key} vs reference")
    np.testing.assert_allclose(got, _single_card()[key], rtol=1e-6,
                               atol=1e-6, err_msg=f"{key} vs tp 1")


def test_marked_parameters_sum_their_gradients_over_tp(ranks):
    """The norm's weight and the row bias see a sequence shard each: their
    gradients are all_reduced (once: the hooks were registered twice), so
    every rank holds the whole gradient, bit for bit alike."""
    for r in ranks:
        assert r["marked"] == (True, True)
    for key in ("dwn", "db2"):
        np.testing.assert_array_equal(ranks[0][key], ranks[1][key])
        half = _single_card()[key]
        assert np.abs(ranks[0][key] - half).max() < 1e-5  # not twice


def test_scatter_and_gather_ops_follow_the_reference(ranks):
    x = _case()["x"]
    ops = [r["ops"] for r in ranks]
    np.testing.assert_array_equal(
        np.concatenate([o["scatter"] for o in ops], axis=1), x)
    for o in ops:
        np.testing.assert_array_equal(o["gather"], x)
        np.testing.assert_array_equal(o["all_gather"], x)
    np.testing.assert_allclose(
        np.concatenate([o["reduce_scatter"] for o in ops], axis=1), 2 * x,
        rtol=0, atol=0)
    # the reference's ops outside a mesh are the identity, as the port's
    for op in ("ScatterOp", "GatherOp"):
        a = torch.from_numpy(x)
        assert getattr(TSP, op).apply(a, axis=1) is a
