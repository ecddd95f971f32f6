"""Weights across the two packages: a LLaMA state dict as numpy arrays (the
JAX model's `state_dict()`, each value turned into an array) onto the
port's modules (`load_llama_state`), and back (`llama_state_to_numpy`, so
trained parameters can be compared with the JAX model's); the same for the
incubate fused layers, `FusedMultiTransformer`'s per-layer lists
(`qkv_weights.0`, ...) and the `nn/transformer.py` layers, any module whose
names equal the JAX layer's (`fused_encoder_state_from_numpy`,
`fused_encoder_state_to_numpy`); and a GPT state (`gpt_state_from_numpy`,
`gpt_state_to_numpy`, `load_gpt_state`).

The port keeps the JAX model's parameter names and Paddle's [in, out]
layout for linears, so the map is one to one; these functions check that
every expected name is present with its shape and that nothing is left
over, then convert. A weight-only quantized linear carries its int8
`quant_weight` and f32 `weight_scale` in place of `weight` (both packages'
`quantize_for_inference`); loading such a state needs a port model
quantized with the same algorithm and group size.
"""
from __future__ import annotations

import numpy as np
import torch

from .framework.device import resolve_device


def llama_param_shapes(config) -> dict:
    """name -> shape of every parameter of `LlamaForCausalLM(config)`."""
    h, i, v = config.hidden_size, config.intermediate_size, config.vocab_size
    hd = h // config.num_attention_heads
    q, kv = config.num_attention_heads * hd, config.num_key_value_heads * hd
    shapes = {"llama.embed_tokens.weight": (v, h)}
    for n in range(config.num_hidden_layers):
        p = f"llama.layers.{n}."
        shapes.update({
            p + "input_layernorm.weight": (h,),
            p + "self_attn.q_proj.weight": (h, q),
            p + "self_attn.k_proj.weight": (h, kv),
            p + "self_attn.v_proj.weight": (h, kv),
            p + "self_attn.o_proj.weight": (q, h),
            p + "post_attention_layernorm.weight": (h,),
            p + "mlp.gate_proj.weight": (h, i),
            p + "mlp.up_proj.weight": (h, i),
            p + "mlp.down_proj.weight": (i, h),
        })
    shapes["llama.norm.weight"] = (h,)
    if not config.tie_word_embeddings:
        shapes["lm_head.weight"] = (h, v)
    return shapes


def _layout(config, names):
    """name -> the float shape it stands for, for a state holding `names`: a
    linear's `<p>.weight` [k, n] may instead be `<p>.quant_weight` and
    `<p>.weight_scale` (both mapped to [k, n]), where the state holds
    those."""
    out = {}
    for name, shape in llama_param_shapes(config).items():
        p = name[:-len("weight")]
        if len(shape) == 2 and name != "llama.embed_tokens.weight" and \
                p + "quant_weight" in names:
            out[p + "quant_weight"] = out[p + "weight_scale"] = shape
        else:
            out[name] = shape
    return out


def _check_quant(name, qw, scale, shape):
    """A quantized linear of float shape [k, n]: int8 [k, n] or packed int4
    [k // 2, n], f32 scales [n] or [groups, n] with groups dividing k."""
    k, n = shape
    ok = (qw.dtype == np.int8 and qw.ndim == 2 and qw.shape[1] == n
          and qw.shape[0] in (k, k // 2) and scale.dtype == np.float32
          and (scale.shape == (n,) or (scale.ndim == 2 and scale.shape[1] == n
                                       and k % scale.shape[0] == 0)))
    if not ok:
        raise ValueError(f"{name}: quantized weight {qw.dtype} "
                         f"{qw.shape} with scales {scale.dtype} "
                         f"{scale.shape} does not fit [{k}, {n}]")


def llama_state_from_numpy(state, config, dtype=torch.float32, device=None):
    """{name: np.ndarray} -> {name: torch.Tensor} on `device`, after
    checking the names and shapes against `config`. Float weights become
    `dtype`; a quantized linear (`<p>.quant_weight` int8 and
    `<p>.weight_scale` f32 in place of `<p>.weight`, as the JAX
    `quantize_for_inference` leaves them) keeps its int8 and f32."""
    layout = _layout(config, set(state))
    missing = sorted(set(layout) - set(state))
    extra = sorted(set(state) - set(layout))
    if missing or extra:
        raise KeyError(f"LLaMA state dict mismatch: missing {missing}, "
                       f"unexpected {extra}")
    dev = resolve_device(device)
    out = {}
    for name in layout:
        arr = np.asarray(state[name])
        if name.endswith(".quant_weight"):
            p = name[:-len("quant_weight")]
            scale = np.asarray(state[p + "weight_scale"])
            _check_quant(p + "weight", arr, scale, layout[name])
            out[name] = torch.from_numpy(np.array(arr)).to(dev)
            out[p + "weight_scale"] = torch.from_numpy(
                np.array(scale)).to(dev)
        elif not name.endswith(".weight_scale"):
            if arr.shape != layout[name]:
                raise ValueError(f"{name}: shape {arr.shape}, expected "
                                 f"{layout[name]}")
            out[name] = torch.from_numpy(
                np.array(arr, dtype=np.float32)).to(dev, dtype)
    return out


def llama_state_to_numpy(model):
    """The weights of a port `LlamaForCausalLM` as {name: np.ndarray}: float
    weights in f32 (the inverse of `load_llama_state` on an f32 model),
    quantized linears as their int8 `quant_weight` and f32 `weight_scale`;
    checked against the LLaMA layout of the model's config."""
    state = {}
    for n, t in model.state_dict().items():
        t = t.detach().cpu()
        state[n] = (t if t.dtype == torch.int8 else t.float()).numpy()
    llama_state_from_numpy(state, model.config, device="cpu")  # the check
    return state


def load_llama_state(model, state):
    """Replace the weights of a port `LlamaForCausalLM` by `state`
    ({name: np.ndarray}), in the model's dtype and on its device."""
    ref = model._backbone_embed_weight()
    model.load_state_dict(
        llama_state_from_numpy(state, model.config, ref.dtype, ref.device),
        strict=True)
    return model


def fused_encoder_state_from_numpy(state, module):
    """{name: np.ndarray} (a JAX layer's state: an incubate layer such as
    `FusedTransformerEncoderLayer` or `FusedMultiTransformer`, a
    `nn/transformer.py` layer, or a stack of them) -> {name: torch.Tensor}
    for the port's `module` of the
    same structure, each in its parameter's dtype and on its device, after
    checking that names and shapes agree; load it with
    `module.load_state_dict`."""
    want = module.state_dict()
    missing = sorted(set(want) - set(state))
    extra = sorted(set(state) - set(want))
    if missing or extra:
        raise KeyError(f"fused encoder state mismatch: missing {missing}, "
                       f"unexpected {extra}")
    out = {}
    for name, ref in want.items():
        arr = np.asarray(state[name], dtype=np.float32)
        if arr.shape != tuple(ref.shape):
            raise ValueError(f"{name}: shape {arr.shape}, expected "
                             f"{tuple(ref.shape)}")
        out[name] = torch.from_numpy(np.array(arr)).to(ref.device, ref.dtype)
    return out


def fused_encoder_state_to_numpy(module):
    """The parameters of a port incubate layer as {name: np.ndarray} in
    f32, named as the JAX layer's."""
    return {n: t.detach().cpu().float().numpy()
            for n, t in module.state_dict().items()}


def gpt_param_shapes(config) -> dict:
    """name -> shape of every parameter of `GPTForCausalLM(config)` (the
    reference's names)."""
    h, i, v = config.hidden_size, config.intermediate_size, config.vocab_size
    shapes = {"gpt.embed_tokens.weight": (v, h),
              "gpt.embed_positions.weight": (config.max_position_embeddings,
                                             h)}
    for n in range(config.num_hidden_layers):
        p = f"gpt.layers.{n}."
        for name, w in (("ln_1", None), ("attn.qkv_proj", (h, 3 * h)),
                        ("attn.out_proj", (h, h)), ("ln_2", None),
                        ("mlp.fc_in", (h, i)), ("mlp.fc_out", (i, h))):
            shapes[p + name + ".weight"] = w or (h,)
            shapes[p + name + ".bias"] = (w[1],) if w else (h,)
    shapes["gpt.ln_f.weight"] = shapes["gpt.ln_f.bias"] = (h,)
    if not config.tie_word_embeddings:
        shapes["lm_head.weight"] = (h, v)
    return shapes


def gpt_state_from_numpy(state, config, dtype=torch.float32, device=None):
    """{name: np.ndarray} (the JAX GPT's state) -> {name: torch.Tensor} in
    `dtype` on `device`, after checking every name and shape against
    `config`."""
    shapes = gpt_param_shapes(config)
    missing = sorted(set(shapes) - set(state))
    extra = sorted(set(state) - set(shapes))
    if missing or extra:
        raise KeyError(f"GPT state dict mismatch: missing {missing}, "
                       f"unexpected {extra}")
    dev = resolve_device(device)
    out = {}
    for name, shape in shapes.items():
        arr = np.asarray(state[name], dtype=np.float32)
        if arr.shape != shape:
            raise ValueError(f"{name}: shape {arr.shape}, expected {shape}")
        out[name] = torch.from_numpy(np.array(arr)).to(dev, dtype)
    return out


def gpt_state_to_numpy(model):
    """The weights of a port `GPTForCausalLM` as {name: np.ndarray} in f32
    (copies: a later step does not move them), checked against the GPT
    layout of its config."""
    state = {n: np.array(t.detach().cpu().float().numpy())
             for n, t in model.state_dict().items()}
    gpt_state_from_numpy(state, model.config, device="cpu")  # the check
    return state


def load_gpt_state(model, state):
    """Replace the weights of a port `GPTForCausalLM` by `state` ({name:
    np.ndarray}), in the model's dtype and on its device."""
    ref = model._backbone_embed_weight()
    model.load_state_dict(
        gpt_state_from_numpy(state, model.config, ref.dtype, ref.device),
        strict=True)
    return model
