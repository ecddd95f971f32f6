"""The core's activations (`paddle_tpu_torch/ops/activation.py`) against
`paddle_tpu/ops/activation.py`: every public function, forward and the
input's gradient of sum(out), atol and rtol 1e-5. The random ones are
held by shape and determinism under `seed`, and where their randomness
drops out (rrelu in eval, gumbel_softmax's hard one-hot rows)."""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as T
from torch_core_cases import Case, args, cpu_place, f32, params, run  # noqa: F401

S = (3, 5)
PLAIN = ["relu", "relu6", "sigmoid", "log_sigmoid", "tanh", "tanhshrink",
         "hardshrink", "softshrink", "hardtanh", "hardsigmoid", "hardswish",
         "elu", "celu", "selu", "silu", "swish", "mish", "leaky_relu",
         "softplus", "softsign", "softmax", "log_softmax",
         "thresholded_relu"]

CASES = (
    [Case(n, args(f32(*S, lo=-4, hi=4))) for n in PLAIN]
    + [Case("gelu", args(f32(*S, lo=-4, hi=4)), id="gelu_exact"),
       Case("gelu", args(f32(*S, lo=-4, hi=4)), kw=dict(approximate=True),
            id="gelu_tanh"),
       Case("softmax", args(f32(2, 3, 4)), kw=dict(axis=1, dtype="float64"),
            id="softmax_dtype"),
       Case("log_softmax", args(f32(2, 3, 4)), kw=dict(axis=0),
            id="log_softmax_axis0"),
       Case("softmax_", args(f32(*S)), grad=False),
       Case("relu_", args(f32(*S)), grad=False),
       Case("elu", args(f32(*S, lo=-3, hi=3)), kw=dict(alpha=0.5),
            id="elu_alpha"),
       Case("leaky_relu", args(f32(*S)), kw=dict(negative_slope=0.2),
            id="leaky_relu_slope"),
       Case("softplus", args(f32(*S, lo=-30, hi=30)),
            kw=dict(beta=2.0, threshold=10.0), id="softplus_beta"),
       Case("hardtanh", args(f32(*S)), kw=dict(min=-0.5, max=0.25),
            id="hardtanh_range"),
       Case("prelu", args(f32(2, 3, 4), f32(3, lo=0.0, hi=0.5))),
       Case("prelu", args(f32(2, 4, 3), f32(3, lo=0.0, hi=0.5)),
            kw=dict(data_format="NHWC"), id="prelu_nhwc"),
       Case("prelu", args(f32(2, 3), f32(1, lo=0.0, hi=0.5)),
            id="prelu_scalar"),
       Case("rrelu", args(f32(*S)), id="rrelu_eval"),
       Case("maxout", args(f32(2, 6, 3)), kw=dict(groups=2)),
       Case("glu", args(f32(3, 6))),
       Case("thresholded_relu", args(f32(*S)), kw=dict(threshold=0.5,
                                                       value=-1.0),
            id="thresholded_relu_value")]
)


@pytest.mark.parametrize("case", params(CASES))
def test_activation_matches_the_reference(case, cpu_place):
    run(case)


def test_rrelu_in_training_draws_its_slopes_from_the_stream(cpu_place):
    x = -torch.ones(4, 8)
    T.seed(5)
    a = T.rrelu(x, training=True)
    T.seed(5)
    b = T.rrelu(x, training=True)
    assert torch.equal(a, b)
    slopes = -a
    assert bool((slopes >= 1 / 8).all()) and bool((slopes <= 1 / 3).all())
    assert len(torch.unique(slopes)) > 1
    assert torch.equal(T.rrelu(torch.ones(3), training=True), torch.ones(3))


def test_gumbel_softmax_rows_are_distributions(cpu_place):
    x = torch.randn(6, 5, requires_grad=True)
    T.seed(1)
    soft = T.gumbel_softmax(x, temperature=0.5)
    T.seed(1)
    assert torch.equal(soft, T.gumbel_softmax(x, temperature=0.5))
    torch.testing.assert_close(soft.sum(-1), torch.ones(6))
    hard = T.gumbel_softmax(x, hard=True)
    assert torch.equal(hard.detach().sum(-1), torch.ones(6))
    assert set(hard.detach().unique().tolist()) <= {0.0, 1.0}
    hard.sum().backward()  # straight-through: the soft sample's gradient
    assert x.grad is not None and np.isfinite(x.grad.numpy()).all()
