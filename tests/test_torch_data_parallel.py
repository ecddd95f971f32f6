"""The port's DataParallel against the JAX package's, on the CPU.

The bucket partition (`_bucket_grads`) is pure and held case by case
against the reference's (`tests/test_overlap_engine.py`). The rest runs
in spawned gloo ranks (`torch_dist_workers.data_parallel_main`, one group
a world size started by a module fixture, with a time limit): W ranks on
shards of each global batch (a DistributedBatchSampler) take 3 AdamW
steps, and their parameters agree with the reference's single-process
steps on the whole batch within 1e-5 relative (each tensor's difference
over its norm, f32); the bucketed reduce against the per-parameter one,
one all_reduce a bucket, `no_sync`, and the permanent per-parameter
fallback when a gradient goes.

Bitwise: at world 2 a bucket's sums equal the lone parameters' (a + b ==
b + a). At world 4 gloo's ring cuts a buffer into pieces by its length, so
an element's four values may be added in another order in a bucket than
alone. Found: with the 4 gradients of this MLP in one bucket, 3 of them
differ from their per-parameter sums by up to 1.2e-7 (one f32 rounding),
while one parameter a bucket (cap 0) equals the per-parameter reduce bit
for bit. So `test_bucketed_equals_per_param` asserts bitwise equality at
world 2, and at world 4 bitwise equality for one parameter a bucket and
agreement within 1e-6 relative for the coalesced bucket.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed import parallel as jpar
from paddle_tpu_torch import get_flags, set_flags
from paddle_tpu_torch.distributed import parallel as tpar
from torch_dist_workers import (GLOBAL_BATCH, LR, STEPS, data_parallel_main,
                                global_batch, mlp_weights, run_group)


@pytest.fixture
def bucket_flags():
    prev = get_flags(["FLAGS_train_overlap", "FLAGS_grad_bucket_mb"])
    jprev = paddle.get_flags(["FLAGS_train_overlap", "FLAGS_grad_bucket_mb"])
    yield
    set_flags(prev)
    paddle.set_flags(jprev)


def _pair_params(shapes, dtypes, seed=0):
    """The same parameters with gradients in both packages."""
    rng = np.random.RandomState(seed)
    jps, tps = [], []
    for s, dt in zip(shapes, dtypes):
        w, g = rng.randn(*s).astype(dt), rng.randn(*s).astype(dt)
        jp = paddle.to_tensor(w)
        jp.grad = paddle.to_tensor(g)
        jps.append(jp)
        tp = torch.nn.Parameter(torch.from_numpy(w))
        tp.grad = torch.from_numpy(g)
        tps.append(tp)
    return jps, tps


def _positions(bucket, params):
    return [next(i for i, q in enumerate(params) if q is p) for p in bucket]


def _same_buckets(jps, tps):
    want = [_positions(b, jps) for b in jpar._bucket_grads(jps)]
    got = [_positions(b, tps) for b in tpar._bucket_grads(tps)]
    assert got == want
    return got


@pytest.mark.parametrize("mb", [25, 1, 0])
def test_buckets_reverse_order_and_cap_match_reference(bucket_flags, mb):
    """Reverse parameter order; the cap closes a bucket (1 MiB: each
    [300, 1024] f32 gradient is 1.2 MiB; 0: one parameter a bucket)."""
    for flags in (set_flags, paddle.set_flags):
        flags({"FLAGS_grad_bucket_mb": mb})
    jps, tps = _pair_params([(300, 1024)] * 3 + [(1024,)] * 3,
                            ["float32"] * 6)
    got = _same_buckets(jps, tps)
    assert [i for b in got for i in b] == [5, 4, 3, 2, 1, 0]
    if mb == 0:
        assert all(len(b) == 1 for b in got)


def test_a_dtype_change_closes_a_bucket(bucket_flags):
    for flags in (set_flags, paddle.set_flags):
        flags({"FLAGS_grad_bucket_mb": 25})
    jps, tps = _pair_params([(64,), (64,), (64,), (32,)],
                            ["float32", "float32", "float16", "float32"])
    assert _same_buckets(jps, tps) == [[3], [2], [1, 0]]


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def ranks(request):
    return request.param, run_group(data_parallel_main, request.param)


def _reference_steps():
    """The reference's MLP (relu between its Linears) taking the 3 AdamW
    steps on each whole global batch."""
    layers = []
    for w, b in mlp_weights():
        lin = paddle.nn.Linear(w.shape[0], w.shape[1])
        lin.weight.set_value(w)
        lin.bias.set_value(b)
        layers.append(lin)
    params = [p for lin in layers for p in (lin.weight, lin.bias)]
    opt = paddle.optimizer.AdamW(learning_rate=LR, parameters=params,
                                 weight_decay=0.01)
    xs, ys = global_batch()
    grads = []
    for s in range(STEPS):
        sl = slice(s * GLOBAL_BATCH, (s + 1) * GLOBAL_BATCH)
        h = paddle.to_tensor(xs[sl])
        for i, lin in enumerate(layers):
            h = lin(h)
            if i < len(layers) - 1:
                h = paddle.nn.functional.relu(h)
        loss = ((h - paddle.to_tensor(ys[sl])) ** 2).mean()
        loss.backward()
        grads.append([np.asarray(p.grad._data).copy() for p in params])
        opt.step()
        opt.clear_grad()
    return [np.asarray(p._data) for p in params], grads


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_data_parallel_steps_match_the_reference_on_the_global_batch(ranks):
    """Every rank's parameters after 3 steps, and each step's averaged
    gradients, within 1e-5 relative of the reference's single process on
    the global batch (rank 0 broadcast its weights at construction: the
    others started perturbed)."""
    world, res = ranks
    want_p, want_g = _reference_steps()
    for r in res:
        for got, want in zip(r["params"], want_p):
            assert _rel(got, want) <= 1e-5
        for step_got, step_want in zip(r["grads"], want_g):
            for got, want in zip(step_got, step_want):
                assert _rel(got, want) <= 1e-5
    for r in res[1:]:  # the ranks stay in step bit for bit
        for a, b in zip(r["params"], res[0]["params"]):
            np.testing.assert_array_equal(a, b)


def test_bucketed_equals_per_param(ranks):
    world, res = ranks
    for r in res:
        for a, b in zip(r["per_param"], r["tiny_buckets"]):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(r["per_param"], r["bucketed"]):
            if world == 2:
                np.testing.assert_array_equal(a, b)
            else:  # gloo's ring adds a bucket's four values in its order
                np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    # every rank holds the same average
    for r in res[1:]:
        for a, b in zip(r["bucketed"], res[0]["bucketed"]):
            np.testing.assert_array_equal(a, b)


def test_one_all_reduce_per_bucket(ranks):
    _, res = ranks
    for r in res:
        c = r["calls"]
        assert c["per_param"] == c["n_params"] == 4
        assert c["bucketed"] == c["n_buckets"] == 1 < c["n_params"]
        assert c["tiny"] == c["n_params"]


def test_no_sync_skips_the_reduce(ranks):
    _, res = ranks
    for r in res:
        assert r["no_sync_calls"] == 0 and r["after_no_sync_calls"] == 1


def test_membership_change_falls_back_for_good(ranks):
    """A gradient gone mid-run: one all_reduce a remaining gradient, and
    the fallback stays when the gradients come back."""
    _, res = ranks
    for r in res:
        assert r["fallback"] == (True, 3)
        assert r["fallback_after"] == (True, 4)


def test_data_parallel_at_dp_1_does_nothing():
    from paddle_tpu_torch.distributed import collective as C
    from torch_dist_workers import _Mlp

    m = tpar.DataParallel(_Mlp(mlp_weights()))
    for p in m.parameters():
        p.grad = torch.ones_like(p)
    C.reset_calls()
    m.sync_gradients()
    assert not C.calls
    assert all(torch.equal(p.grad, torch.ones_like(p))
               for p in m.parameters())
    assert list(m.state_dict()) == [f"layers.{i}.{n}" for i in range(2)
                                    for n in ("weight", "bias")]
    m.set_state_dict({k: torch.zeros_like(v)
                      for k, v in m.state_dict().items()})
    assert all(not p.any() for p in m.parameters())
