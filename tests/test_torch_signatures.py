"""The port's public functions take the reference's arguments (the
signature faults of ROADMAP.md Queue 3): each function's parameter names
against the JAX package's, and each newly taken argument called through
both packages on the same inputs (results within 1e-6, f32)."""
import importlib
import inspect

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed.fleet.layers.mpu import \
    ParallelCrossEntropy as JaxParallelCrossEntropy
from paddle_tpu.inference import ServingEngine as JaxServingEngine
from paddle_tpu.incubate.nn import functional as JIF
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch import amp
from paddle_tpu_torch.incubate.nn import fused_transformer as TIF
from paddle_tpu_torch.inference import ServingEngine
from paddle_tpu_torch.models.llama import LlamaConfig
from paddle_tpu_torch.nn import Embedding, ParallelCrossEntropy
from paddle_tpu_torch.nn import functional as TF

JFA = importlib.import_module("paddle_tpu.nn.functional.attention")
import paddle_tpu.incubate.nn as JINC  # noqa: E402
JFL = importlib.import_module("paddle_tpu.incubate.nn.fused_linear")
import paddle_tpu.models.generation as JGEN  # noqa: E402
import paddle_tpu.nn.transformer as JTR  # noqa: E402
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT  # noqa: E402
import paddle_tpu_torch.incubate.nn as TINC  # noqa: E402
TFL = importlib.import_module("paddle_tpu_torch.incubate.nn.fused_linear")
import paddle_tpu_torch.models.generation as TGEN  # noqa: E402
import paddle_tpu_torch.nn.transformer as TTR  # noqa: E402
from paddle_tpu_torch.models.gpt import GPTForCausalLM  # noqa: E402


def _names(fn):
    return list(inspect.signature(fn).parameters)


PAIRS = {
    "amp.decorate": (paddle.amp.decorate, amp.decorate),
    "amp.auto_cast": (paddle.amp.auto_cast, amp.auto_cast),
    "amp.GradScaler": (paddle.amp.GradScaler.__init__,
                       amp.GradScaler.__init__),
    "F.cross_entropy": (JF.cross_entropy, TF.cross_entropy),
    "F.embedding": (JF.embedding, TF.embedding),
    "F.linear": (JF.linear, TF.linear),
    "F.dropout": (JF.dropout, TF.dropout),
    "F.gelu": (JF.gelu, TF.gelu),
    "F.relu": (JF.relu, TF.relu),
    "F.layer_norm": (JF.layer_norm, TF.layer_norm),
    "F.scaled_dot_product_attention": (JF.scaled_dot_product_attention,
                                       TF.scaled_dot_product_attention),
    "F.flash_attention": (JFA.flash_attention, TF.flash_attention),
    "F.flash_attn_unpadded": (JFA.flash_attn_unpadded,
                              TF.flash_attn_unpadded),
    "ParallelCrossEntropy": (JaxParallelCrossEntropy.__init__,
                             ParallelCrossEntropy.__init__),
    "fused_feedforward": (JIF.fused_feedforward, TIF.fused_feedforward),
    "fused_multi_head_attention": (JIF.fused_multi_head_attention,
                                   TIF.fused_multi_head_attention),
    "ServingEngine": (JaxServingEngine.__init__, ServingEngine.__init__),
}
# the fused encoder layers' forwards
for _cls in ("FusedMultiHeadAttention", "FusedFeedForward",
             "FusedTransformerEncoderLayer"):
    PAIRS[f"{_cls}.forward"] = (getattr(JINC, _cls).forward,
                                getattr(TINC, _cls).forward)
# the public names of the GPT family, nn.transformer and incubate.nn
PAIRS.update({
    "GPTForCausalLM": (JaxGPT.__init__, GPTForCausalLM.__init__),
    "GPTForCausalLM.forward": (JaxGPT.forward, GPTForCausalLM.forward),
    "GPTForCausalLM.forward_cached": (JaxGPT.forward_cached,
                                      GPTForCausalLM.forward_cached),
    "GPTForCausalLM.generate": (JaxGPT.generate, GPTForCausalLM.generate),
    "GPTForCausalLM.init_kv_caches": (JaxGPT.init_kv_caches,
                                      GPTForCausalLM.init_kv_caches),
    "GPTForCausalLM.pp_embed": (JaxGPT.pp_embed, GPTForCausalLM.pp_embed),
    "GPTForCausalLM.pp_head": (JaxGPT.pp_head, GPTForCausalLM.pp_head),
    "generation.generate": (JGEN.generate, TGEN.generate),
    "FusedMultiTransformer.gen_cache": (
        JINC.FusedMultiTransformer.gen_cache,
        TINC.FusedMultiTransformer.gen_cache),
    "Transformer.generate_square_subsequent_mask": (
        JTR.Transformer.generate_square_subsequent_mask,
        TTR.Transformer.generate_square_subsequent_mask),
})
for _cls in ("MultiHeadAttention", "TransformerEncoderLayer",
             "TransformerEncoder", "TransformerDecoderLayer",
             "TransformerDecoder", "Transformer"):
    for _fn in ("__init__", "forward", "gen_cache"):
        if hasattr(getattr(JTR, _cls), _fn):
            PAIRS[f"{_cls}.{_fn}"] = (getattr(getattr(JTR, _cls), _fn),
                                      getattr(getattr(TTR, _cls), _fn))
for _cls in ("FusedMultiTransformer", "FusedBiasDropoutResidualLayerNorm",
             "FusedLinear", "FusedDropoutAdd", "FusedEcMoe"):
    for _fn in ("__init__", "forward"):
        PAIRS[f"{_cls}.{_fn}"] = (getattr(getattr(JINC, _cls), _fn),
                                  getattr(getattr(TINC, _cls), _fn))
for _fn in ("fused_bias_dropout_residual_layer_norm",
            "softmax_mask_fuse_upper_triangle", "fused_dropout_add",
            "fused_rms_norm", "fused_layer_norm", "fused_ec_moe",
            "fused_matmul_bias", "fused_linear"):
    PAIRS[f"incubate.functional.{_fn}"] = (getattr(JINC.functional, _fn),
                                           getattr(TINC.functional, _fn))
PAIRS["incubate.fused_linear_activation"] = (JFL.fused_linear_activation,
                                             TFL.fused_linear_activation)

# the port's own trailing parameters (the entry point's device; a layer's
# dtype, device and the generator its weights come from; a model's seed)
_LAYER = ["dtype", "device", "generator"]
PORT_ONLY = {"ServingEngine": ["device"],
             "GPTForCausalLM": ["device", "seed"],
             "Transformer.generate_square_subsequent_mask": ["device"],
             "FusedBiasDropoutResidualLayerNorm.__init__": ["dtype",
                                                            "device"]}
PORT_ONLY.update({f"{c}.__init__": _LAYER for c in (
    "MultiHeadAttention", "TransformerEncoderLayer",
    "TransformerDecoderLayer", "Transformer", "FusedMultiTransformer",
    "FusedLinear", "FusedEcMoe")})


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_parameter_names_match_the_reference(name):
    ref, port = PAIRS[name]
    extra = PORT_ONLY.get(name, [])
    names = _names(port)
    assert names[len(names) - len(extra):] == extra
    assert names[:len(names) - len(extra)] == _names(ref)


def test_embedding_layer_takes_padding_idx_and_sparse():
    ref = _names(paddle.nn.Embedding.__init__)
    port = _names(Embedding.__init__)
    # the *_attr arguments wait for nn/initializer (Queue 1 item 5)
    assert [n for n in ref if n != "weight_attr"] == port[:len(ref) - 1]
    layer = Embedding(10, 4, padding_idx=3)
    assert not layer.weight[3].any()
    with pytest.raises(NotImplementedError):
        Embedding(10, 4, sparse=True)


def test_gpt3_1p3b_config_matches_the_reference():
    want, got = JaxLlamaConfig.gpt3_1p3b(), LlamaConfig.gpt3_1p3b()
    for field in ("vocab_size", "hidden_size", "intermediate_size",
                  "num_hidden_layers", "num_attention_heads",
                  "num_key_value_heads", "max_position_embeddings",
                  "rms_norm_eps", "rope_theta", "use_recompute",
                  "scan_layers", "fused_ce_chunks", "cp_zigzag_stream"):
        assert getattr(got, field) == getattr(want, field), field
    with pytest.raises(NotImplementedError):
        from paddle_tpu_torch.models.llama import LlamaForCausalLM

        cfg = LlamaConfig.tiny(vocab=32, hidden=32, layers=1, heads=2)
        cfg.cp_zigzag_stream = True
        LlamaForCausalLM(cfg, device="cpu")


def test_decorate_returns_models_and_optimizers():
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW

    m = LlamaForCausalLM(LlamaConfig.tiny(vocab=32, hidden=32, layers=1,
                                          heads=2), device="cpu")
    opt = AdamW(parameters=m.parameters())
    jm = paddle.nn.Linear(2, 2)
    jopt = paddle.optimizer.AdamW(parameters=jm.parameters())
    got = amp.decorate(models=m, optimizers=opt, level="O2")
    want = paddle.amp.decorate(models=jm, optimizers=jopt, level="O2")
    assert isinstance(got, tuple) and len(got) == len(want) == 2
    assert got[0] is m and got[1] is opt
    assert {p.dtype for p in m.parameters()} == {torch.bfloat16}
    ms, opts = amp.decorate([m], opt, "O1", master_weight=True,
                            save_dtype="float32")
    assert ms == [m] and opts is opt
    assert amp.is_float16_supported() and amp.is_bfloat16_supported()


def _both(fn_j, fn_t, *arrays, **kw):
    want = fn_j(*(paddle.to_tensor(a) for a in arrays), **kw)
    got = fn_t(*(torch.from_numpy(a) for a in arrays), **kw)
    return got, want


@pytest.mark.parametrize("kw", [
    dict(weight=True), dict(weight=True, reduction="sum"),
    dict(weight=True, reduction="none"), dict(label_smoothing=0.1),
    dict(use_softmax=False), dict(soft_label=True),
    dict(soft_label=True, weight=True, label_smoothing=0.2),
    dict(name="ce", ignore_index=3)])
def test_cross_entropy_new_arguments_match_reference(kw):
    rng = np.random.RandomState(1)
    logits = rng.randn(4, 6, 9).astype(np.float32)
    if kw.get("use_softmax") is False:
        logits = np.abs(logits) / np.abs(logits).sum(-1, keepdims=True)
    if kw.get("soft_label"):
        lab = rng.rand(4, 6, 9).astype(np.float32)
        lab /= lab.sum(-1, keepdims=True)
    else:
        lab = rng.randint(0, 9, (4, 6))
        lab[0, :2] = kw.get("ignore_index", -100)
    kw = dict(kw)
    w = rng.rand(9).astype(np.float32) + 0.5 if kw.pop("weight", False) \
        else None
    want = JF.cross_entropy(paddle.to_tensor(logits), paddle.to_tensor(lab),
                            weight=None if w is None else paddle.to_tensor(w),
                            **kw)
    got = TF.cross_entropy(torch.from_numpy(logits), torch.from_numpy(lab),
                           weight=None if w is None else torch.from_numpy(w),
                           **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want._data),
                               rtol=1e-6, atol=1e-6)


def test_embedding_padding_idx_and_names_match_reference():
    rng = np.random.RandomState(2)
    w = rng.randn(7, 5).astype(np.float32)
    ids = np.array([[0, 3, 3, 6], [1, 3, 2, 0]])
    got, want = _both(JF.embedding, TF.embedding, ids, w, padding_idx=3,
                      sparse=False, name="emb")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want._data))
    assert not got[0, 1].any()
    with pytest.raises(NotImplementedError):
        TF.embedding(torch.from_numpy(ids), torch.from_numpy(w),
                     sparse=True)


def test_name_arguments_and_flash_entries_match_reference():
    rng = np.random.RandomState(3)
    x = rng.randn(2, 8, 16).astype(np.float32)
    w = rng.randn(16, 16).astype(np.float32)
    for fj, ft, args in ((JF.linear, TF.linear, (x, w)),
                         (JF.relu, TF.relu, (x,)),
                         (JF.gelu, TF.gelu, (x,))):
        got, want = _both(fj, ft, *args, name="n")
        np.testing.assert_allclose(got.numpy(), np.asarray(want._data),
                                   rtol=1e-6, atol=1e-6)
    got, want = _both(JF.layer_norm, TF.layer_norm, x, normalized_shape=16,
                      name="n")
    np.testing.assert_allclose(got.numpy(), np.asarray(want._data),
                               rtol=1e-5, atol=1e-5)
    got, want = _both(JF.dropout, TF.dropout, x, p=0.5, training=False,
                      mode="downscale_in_infer", name="n")
    np.testing.assert_allclose(got.numpy(), np.asarray(want._data),
                               rtol=1e-6)
    q = rng.randn(2, 8, 2, 16).astype(np.float32)
    got, want = _both(JF.scaled_dot_product_attention,
                      TF.scaled_dot_product_attention, q, q, q,
                      is_causal=True, name="n")
    np.testing.assert_allclose(got.numpy(), np.asarray(want._data),
                               atol=1e-5)
    kw = dict(causal=True, return_softmax=True, fixed_seed_offset=None,
              rng_name="r", name="n")
    got, want = _both(JFA.flash_attention, TF.flash_attention, q, q, q, **kw)
    assert got[1] is None and want[1] is None
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]._data),
                               atol=1e-5)
    packed = rng.randn(16, 2, 16).astype(np.float32)
    cu = np.array([0, 5, 16], np.int32)
    kw = dict(causal=True, fixed_seed_offset=None, rng_name="r", name="n")
    want = JFA.flash_attn_unpadded(*(paddle.to_tensor(packed),) * 3,
                                   paddle.to_tensor(cu), paddle.to_tensor(cu),
                                   11, 11, **kw)
    got = TF.flash_attn_unpadded(*(torch.from_numpy(packed),) * 3,
                                 torch.from_numpy(cu), torch.from_numpy(cu),
                                 11, 11, **kw)
    assert got[1] is None
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]._data),
                               atol=1e-5)


def test_parallel_cross_entropy_takes_the_reference_order():
    rng = np.random.RandomState(4)
    logits = rng.randn(2, 5, 9).astype(np.float32)
    lab = rng.randint(0, 9, (2, 5))
    lab[0, 0] = 2
    want = JaxParallelCrossEntropy(None, "ce", 2)(paddle.to_tensor(logits),
                                                  paddle.to_tensor(lab))
    got = ParallelCrossEntropy(None, "ce", 2)(torch.from_numpy(logits),
                                              torch.from_numpy(lab))
    np.testing.assert_allclose(got.numpy(), np.asarray(want._data),
                               rtol=1e-6, atol=1e-6)
    assert got[0, 0, 0] == 0
    with pytest.raises(NotImplementedError):
        ParallelCrossEntropy(mp_group=object())


def test_fused_functionals_take_ring_id_and_name():
    from paddle_tpu_torch.incubate.nn import FusedFeedForward

    layer = FusedFeedForward(16, 32, dropout_rate=0.0, device="cpu")
    x = torch.randn(2, 4, 16)
    args = (x, layer.linear1_weight, layer.linear2_weight)
    a = TIF.fused_feedforward(*args, dropout1_rate=0.0, dropout2_rate=0.0)
    b = TIF.fused_feedforward(*args, dropout1_rate=0.0, dropout2_rate=0.0,
                              ring_id=-1, name="ffn")
    assert torch.equal(a, b)
    with pytest.raises(NotImplementedError):
        TIF.fused_feedforward(*args, ring_id=0)
    with pytest.raises(NotImplementedError):
        TIF.fused_multi_head_attention(x, None, None, ring_id=1)
