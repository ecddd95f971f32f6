"""The core's autograd (`paddle_tpu_torch/autograd/`) against the
reference's tape (`paddle_tpu/autograd/`): the cases of
tests/test_autograd.py run through both packages on the same inputs, and
backward's ones seed and retain_graph, grad's create_graph (second
derivatives), allow_unused, grad_outputs and no_grad_vars, the grad-mode
guards, hooks, PyLayer, saved_tensors_hooks and the functional transforms
(vjp, jvp, jacobian, hessian). Gradients within 1e-5 (f32)."""
import numpy as np
import pytest
import torch

import paddle_tpu as P
import paddle_tpu_torch as T
from torch_core_cases import cpu_place  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)


def npy(t):
    if t is None:
        return None
    if isinstance(t, torch.Tensor):
        return t.detach().numpy()
    return np.asarray(t)


def both(scenario, *arrays):
    """scenario(pkg, *tensors-or-arrays) -> list of arrays (None allowed),
    run through both packages and compared."""
    ref = scenario(P, *[a.copy() for a in arrays])
    port = scenario(T, *[a.copy() for a in arrays])
    assert len(ref) == len(port)
    for r, p in zip(ref, port):
        if r is None or p is None:
            assert r is None and p is None
            continue
        np.testing.assert_allclose(npy(p), npy(r), **TOL)
    return ref, port


def x_of(pkg, a, grad=True):
    return pkg.to_tensor(a, stop_gradient=not grad)


R = np.random.RandomState(3)
A = R.randn(3, 4).astype(np.float32)
B = R.randn(3, 4).astype(np.float32)
V = np.array([2.0, 3.0], np.float32)


def s_scalar_backward(pkg, a):
    x = x_of(pkg, a)
    pkg.sum(pkg.multiply(x, x)).backward()
    return [x.grad]


def s_accumulation(pkg, a):
    x = x_of(pkg, a)
    pkg.sum(x * 2).backward()
    pkg.sum(x * 3).backward()
    return [x.grad]


def s_stop_gradient(pkg, a, b):
    x, y = x_of(pkg, a), x_of(pkg, b, grad=False)
    pkg.sum(x * y).backward()
    return [x.grad, y.grad]


def s_detach(pkg, a):
    x = x_of(pkg, a)
    d = (x * 2).detach()
    pkg.sum(x + d).backward()
    return [x.grad]


def s_retain_graph(pkg, a):
    x = x_of(pkg, a)
    y = pkg.sum(x * x)
    pkg.autograd.backward(y, retain_graph=True)
    pkg.autograd.backward(y)
    return [x.grad]


def s_grad_tensors(pkg, a, b):
    x = x_of(pkg, a)
    y = x * 2
    pkg.autograd.backward([y], [pkg.to_tensor(b)])
    return [x.grad]


def s_ones_seed(pkg, a):
    """A non-scalar output with no gradient given: seeded with ones."""
    x = x_of(pkg, a)
    y = pkg.exp(x) * 3
    pkg.autograd.backward(y)
    return [x.grad]


def s_two_outputs(pkg, a, b):
    x = x_of(pkg, a)
    pkg.autograd.backward([pkg.sin(x), pkg.sum(x * x)],
                          [pkg.to_tensor(b), None])
    return [x.grad]


def s_fanin(pkg, a):
    x = x_of(pkg, a)
    pkg.sum(x * 2 + x * 3).backward()
    return [x.grad]


def s_hook(pkg, a):
    x = x_of(pkg, a)
    seen = []

    def hook(g):
        seen.append(npy(g).copy())
        return g * 2

    x.register_hook(hook)
    h = x * 1
    h.register_hook(lambda g: g + 1)
    # h is used once: the reference fires a non-leaf's hook once a use
    # (h * h: twice), torch once on the summed gradient
    pkg.sum(pkg.square(h)).backward()
    return [x.grad, seen[0]]


def s_grad(pkg, a):
    x = x_of(pkg, a)
    y = pkg.sum(x ** 2)
    (gx,) = pkg.grad(y, [x])
    assert x.grad is None  # grad() stores nothing on its inputs
    single = pkg.grad(pkg.sum(x ** 3), x)
    return [gx, single]


def s_grad_unused(pkg, a, b):
    x, z = x_of(pkg, a), x_of(pkg, b)
    y = pkg.sum(x * 2)
    gx, gz = pkg.grad(y, [x, z], allow_unused=True)
    with pytest.raises(RuntimeError, match="allow_unused"):
        pkg.grad(pkg.sum(x * 2), [x, z])
    return [gx, gz]


def s_grad_outputs(pkg, a, b):
    x = x_of(pkg, a)
    y = pkg.tanh(x)
    (g,) = pkg.grad([y], [x], grad_outputs=[pkg.to_tensor(b)])
    return [g]


def s_no_grad_vars_leaf(pkg, a, b):
    """A leaf in no_grad_vars that is not an input: both agree."""
    x, w = x_of(pkg, a), x_of(pkg, b)
    y = pkg.sum(x * w)
    (g,) = pkg.grad(y, [x], no_grad_vars=[w])
    return [g]


def s_guards(pkg, a):
    x = x_of(pkg, a)
    out = []
    with pkg.no_grad():
        y = x * 2
        out.append(np.array(pkg.is_grad_enabled()))
        with pkg.enable_grad():
            z = x * 3
    with pkg.set_grad_enabled(False):
        w = x * 4
    out.append(np.array(pkg.is_grad_enabled()))

    @pkg.no_grad()
    def f(t):
        return t * 5

    v = f(x)
    sg = [t.stop_gradient if pkg is P else not t.requires_grad
          for t in (y, z, w, v)]
    out.append(np.array(sg))
    return out


def s_pylayer(pkg, a, b):
    class Scaled(pkg.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x, w, k, shift=0.0):
            ctx.save_for_backward(x, w)
            ctx.k = k
            return x * w * k + shift, pkg.argmax(x, axis=1)

        @staticmethod
        def backward(ctx, g, _gi):
            x, w = ctx.saved_tensor  # the reference's is a property
            return g * w * ctx.k, g * x * ctx.k

    x, w = x_of(pkg, a), x_of(pkg, b)
    y, idx = Scaled.apply(x, w, 3.0, shift=1.0)
    pkg.sum(pkg.sin(y)).backward()
    return [y, idx, x.grad, w.grad]


def test_saved_tensor_is_also_paddle_s_method(cpu_place):
    class Sq(T.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x):
            ctx.save_for_backward(x)
            return x * x

        @staticmethod
        def backward(ctx, g):
            (x,) = ctx.saved_tensor()
            assert [t.shape for t in ctx.saved_tensors()] == [x.shape]
            return 2 * g * x

    x = x_of(T, A)
    T.sum(Sq.apply(x)).backward()
    np.testing.assert_allclose(x.grad.numpy(), 2 * A, rtol=1e-6)


def s_pylayer_double(pkg, a):
    """tests/test_autograd.py::TestPyLayer::test_custom_op."""
    class Double(pkg.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x):
            ctx.save_for_backward(x)
            return x * 2

        @staticmethod
        def backward(ctx, grad):
            return grad * 2

    x = x_of(pkg, a)
    pkg.sum(Double.apply(x)).backward()
    return [x.grad]


def s_second_cubic(pkg, v):
    x = x_of(pkg, v)
    (g1,) = pkg.grad(pkg.sum(x ** 3), [x], create_graph=True)
    (g2,) = pkg.grad(pkg.sum(g1), [x])
    return [g1, g2]


def s_second_chain(pkg, v):
    x = x_of(pkg, v[:1] / 4)
    (g1,) = pkg.grad(pkg.sum(pkg.exp(pkg.sin(x))), [x], create_graph=True)
    (g2,) = pkg.grad(g1, [x])
    return [g2]


def s_penalty(pkg, a, b):
    """WGAN-GP's gradient penalty differentiated through the weight."""
    w, x = x_of(pkg, a[:3, :3]), x_of(pkg, b[:2, :3])
    (gx,) = pkg.grad(pkg.sum(pkg.matmul(x, w)), [x], create_graph=True)
    (gw,) = pkg.grad(pkg.sum(gx ** 2), [w])
    return [gw]


def s_backward_create_graph(pkg, v):
    x = x_of(pkg, v[:1] / 2)
    pkg.autograd.backward(pkg.sum(x ** 4), create_graph=True)
    (g2,) = pkg.grad(pkg.sum(x.grad), [x])
    return [g2]


SCENARIOS = {
    "scalar_backward": (s_scalar_backward, A),
    "accumulation": (s_accumulation, A),
    "stop_gradient": (s_stop_gradient, A, B),
    "detach": (s_detach, A),
    "retain_graph": (s_retain_graph, A),
    "grad_tensors": (s_grad_tensors, A, B),
    "ones_seed": (s_ones_seed, A),
    "two_outputs": (s_two_outputs, A, B),
    "fanin": (s_fanin, A),
    "hook": (s_hook, A),
    "grad": (s_grad, A),
    "grad_unused": (s_grad_unused, A, B),
    "grad_outputs": (s_grad_outputs, A, B),
    "no_grad_vars_leaf": (s_no_grad_vars_leaf, A, B),
    "guards": (s_guards, A),
    "pylayer": (s_pylayer, A, B),
    "pylayer_double": (s_pylayer_double, A),
    "second_cubic": (s_second_cubic, V),
    "second_chain": (s_second_chain, V),
    "gradient_penalty": (s_penalty, A, B),
    "backward_create_graph": (s_backward_create_graph, V),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_the_tape_matches_the_reference(name, cpu_place):
    fn, *arrays = SCENARIOS[name]
    both(fn, *arrays)


def test_backward_twice_raises_and_no_graph_raises(cpu_place):
    for pkg in (P, T):
        x = x_of(pkg, A)
        y = pkg.sum(x * x)
        pkg.autograd.backward(y)
        with pytest.raises(RuntimeError):
            pkg.autograd.backward(y)
        with pytest.raises(RuntimeError, match="stop_gradient"):
            pkg.autograd.backward(pkg.sum(x_of(pkg, A, grad=False)))


def test_grad_leaves_other_leaves_alone_where_the_reference_fills_them(
        cpu_place):
    """The reference's grad walks the whole tape and accumulates into every
    leaf that is not an input; Paddle's (and the port's) stores nothing."""
    rx, rw = x_of(P, A), x_of(P, B)
    P.grad(P.sum(rx * rw), [rx])
    np.testing.assert_allclose(np.asarray(rw.grad), A, rtol=1e-6)
    px, pw = x_of(T, A), x_of(T, B)
    T.grad(T.sum(px * pw), [px])
    assert pw.grad is None and px.grad is None


def test_no_grad_vars_stop_the_gradient_where_the_reference_ignores_them(
        cpu_place):
    """Paddle's no_grad_vars take no gradient through them; the reference
    accepts the argument and ignores it."""
    rx = x_of(P, A)
    rh = rx * 2
    (rg,) = P.grad(P.sum(rh * rx), [rx], no_grad_vars=[rh])
    np.testing.assert_allclose(np.asarray(rg), 4 * A, rtol=1e-6)
    px = x_of(T, A)
    ph = px * 2
    (pg,) = T.grad(T.sum(ph * px), [px], no_grad_vars=[ph])
    np.testing.assert_allclose(pg.numpy(), 2 * A, rtol=1e-6)


def test_saved_tensors_hooks_see_what_the_ops_save(cpu_place):
    """torch's hooks: pack at every saved tensor, unpack when the backward
    reads it; the gradients are the reference's."""
    packed, unpacked = [], []

    def pack(t):
        packed.append(tuple(t.shape))
        return t.clone()

    def unpack(t):
        unpacked.append(tuple(t.shape))
        return t

    results = []
    for pkg in (P, T):
        x = x_of(pkg, A)
        with pkg.autograd.saved_tensors_hooks(pack, unpack):
            y = pkg.sum(pkg.sin(x) * x)
        y.backward()
        results.append(npy(x.grad))
    np.testing.assert_allclose(results[1], results[0], **TOL)
    assert packed and unpacked


def _fn(pkg):
    return lambda x, y: pkg.sum(pkg.tanh(x) * y, axis=1)


def _fn2(pkg):
    return lambda x: pkg.exp(x) * 2


@pytest.mark.parametrize("which", ["vjp", "vjp_v", "jvp", "jvp_v",
                                   "jacobian", "jacobian_two",
                                   "hessian", "hessian_two"])
def test_functional_transforms_match_the_reference(which, cpu_place):
    x = A[:2, :3].copy()
    y = B[:2, :3].copy()

    def scenario(pkg, x, y):
        F = pkg.autograd
        tx, ty = pkg.to_tensor(x), pkg.to_tensor(y)
        if which == "vjp":
            out, g = F.vjp(_fn2(pkg), tx)
            return [out, g]
        if which == "vjp_v":
            out, gs = F.vjp(_fn(pkg), [tx, ty],
                            pkg.to_tensor(np.array([1.0, -2.0], np.float32)))
            return [out, *gs]
        if which == "jvp":
            out, t = F.jvp(_fn2(pkg), tx)
            return [out, t]
        if which == "jvp_v":
            out, t = F.jvp(_fn(pkg), [tx, ty], [ty, tx])
            return [out, t]
        if which == "jacobian":
            return [F.jacobian(_fn2(pkg), tx)]
        if which == "jacobian_two":
            return F.jacobian(_fn(pkg), [tx, ty])
        f = lambda a: pkg.sum(pkg.sin(a) * a)  # noqa: E731
        if which == "hessian":
            return [F.hessian(f, tx)]
        g = lambda a, b: pkg.sum(pkg.sin(a) * b * b)  # noqa: E731
        return [h for row in F.hessian(g, [tx, ty]) for h in row]

    both(scenario, x, y)
