"""Weights across the two packages: a LLaMA state dict as numpy arrays (the
JAX model's `state_dict()`, each value turned into an array) onto the
port's modules.

The port keeps the JAX model's parameter names and Paddle's [in, out]
layout for linears, so the map is one to one; these functions check that
every expected name is present with its shape and that nothing is left
over, then convert.
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


def llama_state_from_numpy(state, config, dtype=torch.float32, device=None):
    """{name: np.ndarray} -> {name: torch.Tensor} in `dtype` on `device`,
    after checking the names and shapes against `config`."""
    expected = llama_param_shapes(config)
    missing = sorted(set(expected) - set(state))
    extra = sorted(set(state) - set(expected))
    if missing or extra:
        raise KeyError(f"LLaMA state dict mismatch: missing {missing}, "
                       f"unexpected {extra}")
    dev = resolve_device(device)
    out = {}
    for name, shape in expected.items():
        arr = np.asarray(state[name])
        if arr.shape != shape:
            raise ValueError(f"{name}: shape {arr.shape}, expected {shape}")
        out[name] = torch.from_numpy(
            np.array(arr, dtype=np.float32)).to(dev, dtype)
    return out


def load_llama_state(model, state):
    """Replace the weights of a port `LlamaForCausalLM` by `state`
    ({name: np.ndarray}), in the model's dtype and on its device."""
    ref = model._backbone_embed_weight()
    model.load_state_dict(
        llama_state_from_numpy(state, model.config, ref.dtype, ref.device),
        strict=True)
    return model
