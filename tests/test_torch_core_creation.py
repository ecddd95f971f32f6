"""The core's creation and random ops (`paddle_tpu_torch/ops/creation.py`,
`ops/random_ops.py`) against the reference's: every creation function's
values and dtypes (atol and rtol 1e-5); the random ones by shape, dtype,
range, determinism under `seed` and moments within a stated bar (their
draws come from torch's generators, other numbers than `jax.random`'s).
With no place set, every creation op raises on a machine without CUDA."""
import numpy as np
import pytest
import torch

import paddle_tpu as P
import paddle_tpu_torch as T
from torch_core_cases import Case, args, cpu_place, f32, i64, params, run  # noqa: F401

CASES = [
    Case("zeros", args([2, 3])),
    Case("zeros", args(4, "int32"), id="zeros_int32"),
    Case("ones", args([2, 3], "float64")),
    Case("full", args([2, 3], 1.5)),
    Case("full", args([2], 3), id="full_int_is_default_float"),
    Case("full", args([2], True), id="full_bool"),
    Case("full", args([2, 2], 7, "int64"), id="full_dtype"),
    Case("empty", args([2, 3]), fn=lambda pkg, s: pkg.empty(s).shape),
    Case("zeros_like", args(f32(2, 3)), grad=False),
    Case("ones_like", args(i64(2, 3)), kw=dict(dtype="float32"),
         grad=False),
    Case("full_like", args(f32(2, 3), 2.0), grad=False),
    Case("empty_like", args(f32(2, 3)), grad=False,
         fn=lambda pkg, x: pkg.empty_like(x).shape),
    Case("arange", args(5)),
    Case("arange", args(1, 10, 3), id="arange_step"),
    Case("arange", args(0.0, 1.0, 0.25), id="arange_float"),
    Case("arange", args(0, 5, 1, "float32"), id="arange_dtype"),
    Case("linspace", args(0.0, 1.0, 7)),
    Case("linspace", args(-1, 1, 5, "float64"), id="linspace_float64"),
    Case("logspace", args(0.0, 2.0, 5)),
    Case("eye", args(3)),
    Case("eye", args(2, 4, "int64"), id="eye_rect"),
    Case("tril", args(f32(3, 4))),
    Case("triu", args(f32(3, 4)), kw=dict(diagonal=1)),
    Case("tril_indices", args(4, 3, 0)),
    Case("triu_indices", args(3, 4, 1)),
    Case("diag", args(f32(3))),
    Case("diag", args(f32(3)), kw=dict(offset=-1, padding_value=5.0),
         id="diag_padding"),
    Case("diag", args(f32(3, 4)), kw=dict(offset=1), id="diag_of_matrix"),
    Case("diagflat", args(f32(2, 2)), kw=dict(offset=1)),
    Case("diag_embed", args(f32(2, 3))),
    Case("diag_embed", args(f32(2, 3)), kw=dict(offset=-1),
         id="diag_embed_offset"),
    # the reference's meshgrid and assign return tensors that take no
    # gradient; the port's stay in the graph (Paddle's)
    Case("meshgrid", args(f32(3), f32(4)), grad=False),
    Case("meshgrid", args(lambda rng: [rng.randn(2).astype(np.float32),
                                       rng.randn(3).astype(np.float32)]),
         grad=False, id="meshgrid_list"),
    Case("assign", args(f32(2, 3)), grad=False),
    Case("assign", args(f32(2, 3), np.zeros((2, 3), np.float32)),
         fn=lambda pkg, x, out: pkg.assign(x, out) if pkg is P else
         pkg.assign(x, T.zeros([2, 3])), grad=False, id="assign_output"),
    Case("clone", args(f32(2, 3))),
    Case("complex", args(f32(3), f32(3)), grad=False),
    Case("polar", args(f32(3, lo=0.5, hi=2.0), f32(3)), grad=False),
    Case("one_hot", args(i64(5, lo=0, hi=4), 4)),
    Case("vander", args(f32(4))),
    Case("vander", args(f32(3)), kw=dict(n=4, increasing=True),
         id="vander_increasing"),
    Case("to_tensor", args([[1.0, 2.0], [3.0, 4.0]])),
    Case("to_tensor", args([1, 2, 3]), id="to_tensor_int"),
    Case("to_tensor", args(2.5), id="to_tensor_float"),
    Case("to_tensor", args(np.arange(4.0)), id="to_tensor_float64_array"),
    Case("to_tensor", args(f32(2, 2)), kw=dict(dtype="float16"),
         id="to_tensor_dtype"),
]


@pytest.mark.parametrize("case", params(CASES))
def test_creation_op_matches_the_reference(case, cpu_place):
    run(case)


NO_PLACE = [
    ("zeros", ([2],)), ("ones", ([2],)), ("full", ([2], 1.0)),
    ("empty", ([2],)), ("arange", (3,)), ("linspace", (0.0, 1.0, 3)),
    ("logspace", (0.0, 1.0, 3)), ("eye", (2,)), ("tril_indices", (3, 3)),
    ("triu_indices", (3,)), ("to_tensor", ([1.0],)), ("rand", ([2],)),
    ("randn", ([2],)), ("standard_normal", ([2],)), ("uniform", ([2],)),
    ("normal", ()), ("randint", (5,)), ("randperm", (4,)),
    ("numel", None), ("meshgrid", ([1.0],)),
]


@pytest.mark.parametrize("name,a", NO_PLACE, ids=[n for n, _ in NO_PLACE])
def test_a_new_tensor_with_no_place_needs_cuda(name, a):
    """Without set_device("cpu") a new tensor goes to the card; on a
    machine without one that raises, never lands on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: a new tensor lands on it")
    if a is None:  # a function of a tensor keeps its device
        assert T.numel(torch.ones(2, 3)).device.type == "cpu"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        getattr(T, name)(*a)


def test_an_explicit_cpu_place_needs_no_set_device():
    t = T.to_tensor([1.0, 2.0], place=T.CPUPlace())
    assert t.device.type == "cpu" and t.dtype == torch.float32
    assert T.to_tensor([1], place="cpu").dtype == torch.int64


RANDOM = [
    ("rand", lambda: T.rand([400, 50]), (0.0, 1.0), 0.5, 1 / 12),
    ("randn", lambda: T.randn([400, 50]), None, 0.0, 1.0),
    ("standard_normal", lambda: T.standard_normal([400, 50]), None, 0.0,
     1.0),
    ("uniform", lambda: T.uniform([400, 50], min=-2.0, max=4.0),
     (-2.0, 4.0), 1.0, 3.0),
    ("normal", lambda: T.normal(1.0, 2.0, [400, 50]), None, 1.0, 4.0),
    ("normal_tensor", lambda: T.normal(T.full([400, 50], -1.0),
                                       T.full([400, 50], 0.5)), None,
     -1.0, 0.25),
    ("randint", lambda: T.randint(-3, 7, [400, 50]), (-3, 6), 1.5, 99 / 12),
    ("randint_like", lambda: T.randint_like(T.zeros([400, 50]), 0, 4),
     (0, 3), 1.5, 15 / 12),
    ("randperm", lambda: T.randperm(20000), (0, 19999), 9999.5,
     (20000 ** 2 - 1) / 12),
    ("bernoulli", lambda: T.bernoulli(T.full([400, 50], 0.3)), (0, 1), 0.3,
     0.21),
    ("poisson", lambda: T.poisson(T.full([400, 50], 3.0)), (0, None), 3.0,
     3.0),
    ("multinomial", lambda: T.multinomial(T.to_tensor([0.2, 0.3, 0.5]),
                                          20000, replacement=True),
     (0, 2), 1.3, 0.61),
    ("binomial", lambda: T.binomial(T.full([400, 50], 10.0),
                                    T.full([400, 50], 0.4)), (0, 10),
     4.0, 2.4),
    ("standard_gamma", lambda: T.standard_gamma(T.full([400, 50], 2.0)),
     (0, None), 2.0, 2.0),
    ("uniform_", lambda: T.ops.random_ops.uniform_(T.zeros([400, 50]),
                                                   0.0, 2.0),
     (0.0, 2.0), 1.0, 1 / 3),
    ("normal_", lambda: T.ops.random_ops.normal_(T.zeros([400, 50]), 2.0,
                                                 0.5), None, 2.0, 0.25),
    ("exponential_", lambda: T.ops.random_ops.exponential_(
        T.zeros([400, 50]), 2.0), (0, None), 0.5, 0.25),
    ("bernoulli_", lambda: T.ops.random_ops.bernoulli_(T.zeros([400, 50]),
                                                       0.25), (0, 1), 0.25,
     0.1875),
    ("geometric_", lambda: T.geometric_(T.zeros([400, 50]), 0.5), (1, None),
     2.0, 2.0),
    ("log_normal_", lambda: T.ops.random_ops.log_normal_(
        T.zeros([400, 50]), 0.0, 0.25), (0, None),
     float(np.exp(0.03125)), float((np.exp(0.0625) - 1) * np.exp(0.0625))),
    ("cauchy_", lambda: T.ops.random_ops.cauchy_(T.zeros([400, 50]), 1.0,
                                                 0.5), None, None, None),
]


@pytest.mark.parametrize("name,draw,bounds,mean,var", RANDOM,
                         ids=[r[0] for r in RANDOM])
def test_random_op_draws_from_the_port_s_stream(name, draw, bounds, mean,
                                                var, cpu_place):
    """Repeatable under seed, another draw after it, inside its range,
    its mean within 6 standard errors and its variance within 10 %
    (cauchy: its median within 0.05). One thread: a CPU kernel's chunks
    follow the thread count, and a chunk's vectorised exp, log or tan may
    round an element one ulp apart from the scalar tail's."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        T.seed(11)
        a = draw()
        T.seed(11)
        b = draw()
        c = draw()
    finally:
        torch.set_num_threads(threads)
    assert torch.equal(a, b), name
    assert not torch.equal(a, c), name
    v = a.double().reshape(-1)
    if bounds is not None:
        lo, hi = bounds
        assert float(v.min()) >= lo and (hi is None or float(v.max()) <= hi)
    if mean is None:
        assert abs(float(v.median()) - 1.0) < 0.05
        return
    n = v.numel()
    assert abs(float(v.mean()) - mean) < 6 * (var / n) ** 0.5, name
    assert abs(float(v.var()) - var) < 0.1 * var, name


def test_random_dtypes_and_shapes_follow_the_reference(cpu_place):
    for name, a in (("rand", ([2, 3],)), ("randn", ([4],)),
                    ("uniform", ([3, 2],)), ("randint", (5, None, [2, 2])),
                    ("randperm", (6,))):
        r, t = getattr(P, name)(*a), getattr(T, name)(*a)
        assert list(t.shape) == list(r.shape), name
        assert str(np.asarray(r).dtype) == str(t.numpy().dtype), name
    r = P.randperm(6).numpy()
    assert sorted(T.randperm(6).tolist()) == sorted(r.tolist())
    assert T.uniform([3], seed=7).tolist() == T.uniform([3], seed=7).tolist()
    m = T.multinomial(T.to_tensor([[0.1, 0.0, 0.9], [0.5, 0.5, 0.0]]), 2)
    assert m.shape == (2, 2) and m.dtype == torch.int64
    assert set(m[0].tolist()) == {0, 2} and set(m[1].tolist()) == {0, 1}
