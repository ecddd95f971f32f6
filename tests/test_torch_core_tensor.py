"""The core's tensors, dtypes and places (`paddle_tpu_torch/tensor.py`,
`framework/{dtype,device,config}.py`, `device/`) against the reference's:
to_tensor's conversion rules (a float64 array or a Python float becomes
the default dtype, a Python int int64, an ml_dtypes bfloat16 array
bfloat16, stop_gradient the inverse of requires_grad), set_default_dtype,
finfo / iinfo, Paddle's places and set_device, Parameter, numel and the
package root's helpers."""
import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as P
import paddle_tpu_torch as T
from paddle_tpu_torch.framework import device as tdevice
from paddle_tpu_torch.framework import dtype as tdtype
from torch_core_cases import cpu_place  # noqa: F401

NAMES = ["bool", "uint8", "int8", "int16", "int32", "int64", "float16",
         "bfloat16", "float32", "float64", "complex64", "complex128"]


@pytest.mark.parametrize("name", NAMES)
def test_dtype_names_are_torch_dtypes(name):
    d = getattr(T, name)
    assert isinstance(d, T.DType) and isinstance(d, torch.dtype)
    assert tdtype.dtype_name(d) == name == getattr(P, name).name
    assert tdtype.to_torch_dtype(name) is d
    assert tdtype.to_torch_dtype("paddle." + name) is d
    assert tdtype.to_torch_dtype(P.framework.dtype.to_np_dtype(name)) is d
    assert str(tdtype.to_np_dtype(d)) == str(
        P.framework.dtype.to_np_dtype(name))
    assert tdtype.is_floating_dtype(d) == \
        P.framework.dtype.is_floating_dtype(name)


CONVERSIONS = {
    "python_float": 2.5,
    "python_int": 7,
    "python_bool": True,
    "float_list": [[1.0, 2.0], [3.5, 4.0]],
    "int_list": [1, 2, 3],
    "float64_array": np.arange(6.0).reshape(2, 3),
    "float32_array": np.ones(3, np.float32),
    "int32_array": np.arange(4, dtype=np.int32),
    "complex128_array": np.array([1 + 2j]),
    "bfloat16_array": np.array([1.5, -2.25, 3.0], ml_dtypes.bfloat16),
    "float16_array": np.array([0.5], np.float16),
}


@pytest.mark.parametrize("name", sorted(CONVERSIONS))
def test_to_tensor_converts_as_the_reference(name, cpu_place):
    data = CONVERSIONS[name]
    r, t = P.to_tensor(data), T.to_tensor(data)
    assert tdtype.dtype_name(t.dtype) == r.dtype.name
    assert list(t.shape) == r.shape and t.device.type == "cpu"
    want = np.asarray(r).astype(np.float64 if r.dtype.name == "bfloat16"
                                else np.asarray(r).dtype)
    got = t.float() if t.dtype == torch.bfloat16 else t
    np.testing.assert_array_equal(got.numpy().astype(want.dtype), want)


def test_to_tensor_copies_and_carries_stop_gradient(cpu_place):
    a = np.ones(3, np.float32)
    t = T.to_tensor(a, stop_gradient=False)
    a[0] = 5.0
    assert float(t[0]) == 1.0 and t.requires_grad and t.is_leaf
    assert not T.to_tensor(a).requires_grad
    # from a tensor: stop_gradient=True detaches and copies
    d = T.to_tensor(t)
    assert not d.requires_grad and d.data_ptr() != t.data_ptr()
    # stop_gradient=False keeps a non-leaf in the graph (the reference
    # keeps its tape node), a leaf gives a new leaf
    h = t * 2
    k = T.to_tensor(h, stop_gradient=False)
    T.sum(k).backward()
    np.testing.assert_allclose(t.grad.numpy(), [2.0, 2.0, 2.0])
    leaf = T.to_tensor(t, stop_gradient=False)
    assert leaf.is_leaf and leaf.requires_grad and leaf is not t
    c = T.to_tensor(t, dtype="float64")
    assert c.dtype == torch.float64 and not c.requires_grad


def test_default_dtype_rules(cpu_place):
    assert T.get_default_dtype() == P.get_default_dtype() == "float32"
    for pkg in (P, T):
        pkg.set_default_dtype("float64")
    try:
        assert T.get_default_dtype() == "float64"
        for data in (2.5, np.arange(3.0), [1.0, 2.0]):
            r, t = P.to_tensor(data), T.to_tensor(data)
            assert tdtype.dtype_name(t.dtype) == r.dtype.name == "float64"
        assert T.ones([2]).dtype == torch.float64
        assert T.full([2], 3).dtype == torch.float64
        assert T.arange(0.0, 1.0, 0.5).dtype == torch.float64
        assert T.to_tensor([1, 2]).dtype == torch.int64
    finally:
        for pkg in (P, T):
            pkg.set_default_dtype("float32")
    T.set_default_dtype(T.bfloat16)
    try:
        assert T.get_default_dtype() == "bfloat16"
        assert T.zeros([1]).dtype == torch.bfloat16
    finally:
        T.set_default_dtype("float32")


@pytest.mark.parametrize("name", ["float16", "bfloat16", "float32",
                                  "float64"])
def test_finfo_matches_the_reference(name):
    r, t = P.finfo(name), T.finfo(name)
    for key in ("min", "max", "eps", "tiny", "smallest_normal",
                "resolution", "bits", "dtype"):
        assert getattr(t, key) == getattr(r, key), key


@pytest.mark.parametrize("name", ["uint8", "int8", "int16", "int32",
                                  "int64"])
def test_iinfo_matches_the_reference(name):
    r, t = P.iinfo(name), T.iinfo(getattr(T, name))
    assert (t.min, t.max, t.bits, t.dtype) == (r.min, r.max, r.bits,
                                                r.dtype)


def test_places_are_paddle_s_gpu_places():
    assert T.CPUPlace() == "cpu" and T.CPUPlace().is_cpu_place()
    g = T.CUDAPlace(1)
    assert g.is_gpu_place() and g == "gpu:1" and g == "cuda:1"
    assert g != T.CPUPlace() and repr(g) == "Place(gpu:1)"
    assert T.Place("gpu", 0) == torch.device("cuda", 0)
    assert hash(T.CUDAPlace(0)) == hash(T.Place("gpu", 0))
    with pytest.raises(RuntimeError, match="NVIDIA GPUs"):
        T.TPUPlace(0)
    with pytest.raises(RuntimeError, match="NVIDIA GPUs"):
        T.set_device("tpu")
    assert T.is_compiled_with_tpu() is False
    assert T.is_compiled_with_xpu() is False
    assert T.is_compiled_with_custom_device("tpu") is False
    assert isinstance(T.is_compiled_with_cuda(), bool)
    assert T.is_compiled_with_distribute() is True


def test_set_device_chooses_where_new_tensors_land():
    prev = tdevice._current_place
    try:
        tdevice._current_place = None
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA"):
                T.get_device()
            with pytest.raises(RuntimeError, match="CUDA"):
                T.set_device("gpu")
            with pytest.raises(RuntimeError, match="CUDA"):
                T.set_device(T.CUDAPlace(0))
            with pytest.raises(RuntimeError, match="CUDA"):
                tdevice.resolve_device(None)
        place = T.set_device("cpu")
        assert place == T.CPUPlace() and T.get_device() == "cpu:0"
        assert tdevice.resolve_device(None) == torch.device("cpu")
        assert T.device.current_place() == T.CPUPlace()
        assert T.zeros([1]).device.type == "cpu"
        T.device.synchronize()  # nothing to wait for on the CPU
        assert T.device_count() == torch.cuda.device_count()
        assert T.device.get_available_device() == (
            [f"gpu:{i}" for i in range(torch.cuda.device_count())]
            or ["cpu"])
        with pytest.raises(ValueError, match="unsupported device"):
            T.set_device("npu")
    finally:
        tdevice._current_place = prev


def test_streams_and_events_need_a_gpu(cpu_place):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="GPU"):
        T.device.Stream()
    with pytest.raises(RuntimeError, match="GPU"):
        T.device.cuda.Event()
    assert T.device.stream_guard(None) is not None


def test_parameter_is_a_trainable_torch_parameter(cpu_place):
    r = P.Parameter(np.ones((2, 2), np.float32))
    p = T.Parameter(np.ones((2, 2), np.float32))
    assert isinstance(p, torch.nn.Parameter) and p.requires_grad
    assert p.trainable == r.trainable is True
    frozen = T.Parameter(torch.zeros(3), dtype="float64", trainable=False)
    assert frozen.dtype == torch.float64 and not frozen.requires_grad
    frozen.trainable = True
    assert frozen.requires_grad
    m = torch.nn.Module()
    m.w = T.Parameter(torch.ones(2))
    assert [n for n, _ in m.named_parameters()] == ["w"]
    assert type(m.w * 2) is torch.Tensor


def test_root_helpers_match_the_reference(cpu_place):
    x = np.ones((2, 3), np.float32)
    assert int(T.numel(T.to_tensor(x))) == int(P.numel(P.to_tensor(x)))
    assert T.numel(T.to_tensor(x)).dtype == torch.int64
    assert T.is_tensor(T.to_tensor(x)) and not T.is_tensor(x)
    assert T.in_dynamic_mode() is True and P.in_dynamic_mode() is True
    assert T.version() == T.__version__
    assert isinstance(T.Tensor, type) and T.Tensor is torch.Tensor
    with T.LazyGuard():
        pass
    T.seed(3)
    state = T.get_cuda_rng_state()
    a = T.rand([3])
    T.set_cuda_rng_state(state)
    assert torch.equal(a, T.rand([3]))
    T.set_printoptions(precision=3)
    try:
        assert "1.235" in repr(torch.tensor([1.23456]))
    finally:
        torch.set_printoptions(profile="default")


def test_every_public_op_has_a_parity_case():
    """Each public function of the port's ops modules is called by some
    case of tests/test_torch_core_*.py."""
    import inspect

    import test_torch_core_activation as act
    import test_torch_core_creation as cre
    import test_torch_core_linalg as lin
    import test_torch_core_manipulation as man
    import test_torch_core_math as mat
    import test_torch_core_reduction as red
    from paddle_tpu_torch import ops

    covered = {c.name for mod, tables in (
        (act, ("CASES",)), (cre, ("CASES",)), (lin, ("CASES",)),
        (man, ("CASES",)), (mat, ("CASES",)),
        (red, ("REDUCTION", "LOGIC", "SEARCH"))) for t in tables
        for c in getattr(mod, t)}
    covered |= {r[0] for r in cre.RANDOM}
    # tests of their own: the random activations, the in-place family
    # (every name), indexing
    covered |= {"rrelu", "gumbel_softmax", "getitem", "setitem_",
                "where_", "apply_op", "as_array", "to_tensor",
                "standard_gamma", "normal", "binomial"}
    covered |= set(ops.inplace.__all__)
    uncovered = []
    for mod in (ops.activation, ops.creation, ops.indexing, ops.linalg,
                ops.logic, ops.manipulation, ops.math, ops.random_ops,
                ops.reduction, ops.search):
        for n, obj in vars(mod).items():
            if n.startswith("_") or not inspect.isfunction(obj) or \
                    obj.__module__ != mod.__name__:
                continue
            if n not in covered:
                uncovered.append(f"{mod.__name__}.{n}")
    assert uncovered == []


def test_apply_op_keeps_the_reference_s_amp_and_op_stats(cpu_place):
    """Under auto_cast the core's ops cast by the reference's lists (a
    matmul's f32 inputs to bf16, exp's bf16 input to f32, add untouched),
    as the reference's `_apply_op` does; under FLAGS_benchmark each records
    its Paddle name."""
    from paddle_tpu_torch.framework import op_stats

    a = np.random.RandomState(0).rand(4, 4).astype(np.float32)
    got = {}
    for pkg in (P, T):
        x = pkg.to_tensor(a)
        with pkg.amp.auto_cast(True, level="O1", dtype="bfloat16"):
            mm = pkg.matmul(x, x)
            ex = pkg.exp(pkg.cast(x, "bfloat16"))
            ad = pkg.add(x, x)
        got[pkg] = [str(t.dtype).replace("paddle.", "").replace(
            "torch.", "") for t in (mm, ex, ad)]
    assert got[T] == got[P] == ["bfloat16", "float32", "float32"]
    T.amp.debugging.enable_operator_stats_collection()
    try:
        x = T.to_tensor(a)
        T.add(T.matmul(x, x), x)
    finally:
        stats = T.amp.debugging.disable_operator_stats_collection(
            print_summary=False)
    assert stats.get("matmul") == 1 and stats.get("add") == 1
    op_stats.reset()
