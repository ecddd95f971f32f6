"""Shared set-up of the parity tests between `paddle_tpu` (JAX on the CPU)
and its PyTorch port `paddle_tpu_torch` (torch on the CPU): the tiny GQA
LLaMA built in both packages on the same weights."""
from __future__ import annotations

import numpy as np

import paddle_tpu as paddle
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.weights import load_llama_state

# 2 layers, hidden 128, 4 query heads over 2 kv heads (head_dim 32), vocab
# 256; serving tests use page size 8
TINY = dict(vocab=256, hidden=128, layers=2, heads=4, seq=64)
KV_HEADS = 2
PAGE = 8


def jax_state(model):
    return {k: np.asarray(v._data) for k, v in model.state_dict().items()}


def tiny_pair(seed=0, tie=False):
    """(jax_model, torch_model, torch_config) on identical f32 weights."""
    paddle.seed(seed)
    jcfg = JaxLlamaConfig.tiny(**TINY)
    jcfg.num_key_value_heads = KV_HEADS
    jcfg.tie_word_embeddings = tie
    jm = JaxLlama(jcfg)
    jm.eval()
    tcfg = LlamaConfig.tiny(**TINY)
    tcfg.num_key_value_heads = KV_HEADS
    tcfg.tie_word_embeddings = tie
    tm = LlamaForCausalLM(tcfg, device="cpu")
    load_llama_state(tm, jax_state(jm))
    return jm, tm, tcfg


def serving_pair(seed=0):
    """(jax_model, torch_model) of the reference's serving tests
    (`tests/test_serving_burst.py::_tiny_model`): 2 layers, hidden 32, 4
    heads of 8, vocab 97, 64 positions, f32, identical weights."""
    paddle.seed(seed)
    jcfg = JaxLlamaConfig.tiny(vocab=97, hidden=32, layers=2, heads=4,
                               seq=64)
    jm = JaxLlama(jcfg)
    jm.eval()
    tm = LlamaForCausalLM(LlamaConfig.tiny(vocab=97, hidden=32, layers=2,
                                           heads=4, seq=64), device="cpu")
    load_llama_state(tm, jax_state(jm))
    return jm, tm


def serve(engine, prompts, max_news, **kw):
    """Queue one request per prompt, run the engine dry, and return the
    output streams (lists) in request order."""
    rids = [engine.add_request(p, max_new_tokens=n, **kw)
            for p, n in zip(prompts, max_news)]
    done = {f.request_id: np.asarray(f.output_ids).tolist()
            for f in engine.run()}
    assert sorted(done) == sorted(rids)
    return [done[r] for r in rids]
