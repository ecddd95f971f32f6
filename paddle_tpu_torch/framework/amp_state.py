"""The auto-cast state and op lists (counterpart of
`paddle_tpu/framework/amp_state.py`, with the reference's lists keyed by
its op names), and `cast_inputs`, the cast that each ported functional on
a list applies to its inputs first, as the reference's `tensor._apply_op`
does (`paddle_tpu/tensor.py:438-455`).

While `amp.auto_cast` is on: an op on the white list takes its float32
inputs in the auto-cast dtype; an op on the black list takes its float16 /
bfloat16 inputs in float32; any other op, or an op on neither list, takes
its inputs as they are. This is not `torch.autocast`: its lists are not
the reference's, and it never casts the inputs of the port's kernels.
"""
import torch

enabled = False
amp_dtype = None
level = "O1"

# ops whose inputs are cast down (the matrix-unit ops)
white_list = {
    "matmul", "bmm", "mm", "linear", "conv1d", "conv2d", "conv3d", "einsum",
    "sdpa", "flash_attention", "addmm", "mv",
}
# ops kept in f32 for numerics
black_list = {
    "exp", "log", "pow", "square", "sqrt", "rsqrt", "softmax", "log_softmax",
    "cross_entropy", "bce_with_logits", "mean", "sum", "var", "std", "norm",
    "layer_norm", "batch_norm", "rms_norm", "logsumexp", "erf", "erfinv",
    "cumsum", "prod",
}

_LOW = (torch.float16, torch.bfloat16)


def cast_inputs(name, *tensors):
    """`tensors` as op `name` takes them under the current auto-cast state
    (None entries pass through)."""
    if not enabled or amp_dtype is None:
        return tensors
    if name in white_list:
        return tuple(t.to(amp_dtype) if t is not None
                     and t.dtype == torch.float32 else t for t in tensors)
    if name in black_list:
        return tuple(t.float() if t is not None and t.dtype in _LOW else t
                     for t in tensors)
    return tensors
