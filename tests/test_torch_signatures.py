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

# the open faults of ROADMAP Queue 3 items 1-5, closed: the fused encoder
# layers' constructors, seed, rope, refresh_params and the plain layers'
# name / weight_attr
for _cls in ("FusedMultiHeadAttention", "FusedFeedForward",
             "FusedTransformerEncoderLayer"):
    PAIRS[f"{_cls}.__init__"] = (getattr(JINC, _cls).__init__,
                                 getattr(TINC, _cls).__init__)
import paddle_tpu.nn.functional.rope as JROPE  # noqa: E402
import paddle_tpu.nn.quant as JQ  # noqa: E402
import paddle_tpu_torch as ptt  # noqa: E402
import paddle_tpu_torch.nn as TNN  # noqa: E402
import paddle_tpu_torch.nn.quant as TQ  # noqa: E402
PAIRS.update({
    "seed": (paddle.seed, ptt.seed),
    "F.apply_rope": (JROPE.apply_rope, TF.apply_rope),
    "F.fused_rotary_position_embedding": (
        JROPE.fused_rotary_position_embedding,
        TF.fused_rotary_position_embedding),
    "incubate.functional.fused_rotary_position_embedding": (
        JROPE.fused_rotary_position_embedding,
        TINC.functional.fused_rotary_position_embedding),
    "ServingEngine.refresh_params": (JaxServingEngine.refresh_params,
                                     ServingEngine.refresh_params),
    "nn.Dropout": (paddle.nn.Dropout.__init__, TNN.Dropout.__init__),
    "nn.Embedding": (paddle.nn.Embedding.__init__, Embedding.__init__),
    "WeightOnlyLinear": (JQ.WeightOnlyLinear.__init__,
                         TQ.WeightOnlyLinear.__init__),
})

# the data-parallel fine-tune's public names
import paddle_tpu.distributed as JD  # noqa: E402
import paddle_tpu.distributed.stream as JDS  # noqa: E402
import paddle_tpu_torch.distributed as TD  # noqa: E402
import paddle_tpu_torch.distributed.stream as TDS  # noqa: E402
from paddle_tpu.amp import debugging as JDBG  # noqa: E402
from paddle_tpu.distributed import collective as JDC  # noqa: E402
from paddle_tpu.distributed import mesh as JDM  # noqa: E402
from paddle_tpu.distributed.store import TCPStore as JTCPStore  # noqa: E402
from paddle_tpu.io import shm_queue as JSHM  # noqa: E402
from paddle_tpu_torch.amp import debugging as TDBG  # noqa: E402
from paddle_tpu_torch.distributed import collective as TDC  # noqa: E402
from paddle_tpu_torch.distributed import mesh as TDM  # noqa: E402
from paddle_tpu_torch.distributed.store import TCPStore  # noqa: E402
from paddle_tpu_torch.io import DataLoader as TDataLoader  # noqa: E402
from paddle_tpu_torch.io import shm_queue as TSHM  # noqa: E402
from paddle_tpu_torch.optimizer import LBFGS as TLBFGS  # noqa: E402
for _fn in ("all_reduce", "all_gather", "broadcast", "reduce", "scatter",
            "reduce_scatter", "gather", "alltoall", "alltoall_single",
            "send", "recv", "isend", "irecv", "batch_isend_irecv", "barrier",
            "new_group", "get_group", "wait", "all_gather_object",
            "broadcast_object_list", "scatter_object_list",
            "destroy_process_group", "get_backend", "is_available",
            "gloo_barrier", "psum", "all_gather_jit", "psum_scatter",
            "ppermute", "all_to_all_jit"):
    PAIRS[f"distributed.{_fn}"] = (getattr(JDC, _fn), getattr(TDC, _fn))
for _fn in ("all_reduce", "all_gather", "broadcast", "reduce",
            "reduce_scatter", "scatter", "alltoall", "send", "recv"):
    PAIRS[f"distributed.stream.{_fn}"] = (getattr(JDS, _fn),
                                          getattr(TDS, _fn))
for _fn in ("build_mesh", "set_mesh", "get_mesh", "init_mesh", "axis_size"):
    PAIRS[f"distributed.mesh.{_fn}"] = (getattr(JDM, _fn), getattr(TDM, _fn))
PAIRS.update({
    "distributed.P2POp": (JDC.P2POp.__init__, TDC.P2POp.__init__),
    "distributed.DataParallel": (JD.DataParallel.__init__,
                                 TD.DataParallel.__init__),
    "distributed.spawn": (JD.spawn, TD.spawn),
    "distributed.get_rank": (JD.get_rank, TD.get_rank),
    "distributed.get_world_size": (JD.get_world_size, TD.get_world_size),
    "distributed.init_parallel_env": (JD.init_parallel_env,
                                      TD.init_parallel_env),
    "CommunicateTopology": (JDM.CommunicateTopology.__init__,
                            TDM.CommunicateTopology.__init__),
    "HybridCommunicateGroup": (JDM.HybridCommunicateGroup.__init__,
                               TDM.HybridCommunicateGroup.__init__),
    "TCPStore": (JTCPStore.__init__, TCPStore.__init__),
    "TCPStore.barrier": (JTCPStore.barrier, TCPStore.barrier),
    "TCPStore.wait": (JTCPStore.wait, TCPStore.wait),
    "ShmRing": (JSHM.ShmRing.__init__, TSHM.ShmRing.__init__),
    "save": (paddle.save, ptt.save),
    "load": (paddle.load, ptt.load),
    "LBFGS": (paddle.optimizer.LBFGS.__init__, TLBFGS.__init__),
    "amp.debugging.check_numerics": (JDBG.check_numerics,
                                     TDBG.check_numerics),
    "amp.debugging.enable_tensor_checker": (JDBG.enable_tensor_checker,
                                            TDBG.enable_tensor_checker),
    "amp.debugging.TensorCheckerConfig": (JDBG.TensorCheckerConfig.__init__,
                                          TDBG.TensorCheckerConfig.__init__),
    "amp.debugging.disable_operator_stats_collection": (
        JDBG.disable_operator_stats_collection,
        TDBG.disable_operator_stats_collection),
    "io.DataLoader": (paddle.io.DataLoader.__init__, TDataLoader.__init__),
})

# the port's own trailing parameters (the entry point's device; a layer's
# dtype, device and the generator its weights come from; a model's seed)
_LAYER = ["dtype", "device", "generator"]
PORT_ONLY = {"ServingEngine": ["device"],
             "GPTForCausalLM": ["device", "seed"],
             "Transformer.generate_square_subsequent_mask": ["device"],
             "FusedBiasDropoutResidualLayerNorm.__init__": ["dtype",
                                                            "device"],
             "nn.Embedding": ["dtype", "device"],
             # the rank's device and the rendezvous' time limit
             "distributed.init_parallel_env": ["device", "timeout"],
             "WeightOnlyLinear": ["device"]}
PORT_ONLY.update({f"{c}.__init__": _LAYER for c in (
    "MultiHeadAttention", "TransformerEncoderLayer",
    "TransformerDecoderLayer", "Transformer", "FusedMultiTransformer",
    "FusedLinear", "FusedEcMoe", "FusedMultiHeadAttention",
    "FusedFeedForward", "FusedTransformerEncoderLayer")})


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
    # weight_attr in its place, taking only None until nn/initializer
    # (Queue 1 item 5)
    assert ref == port[:len(ref)]
    layer = Embedding(10, 4, padding_idx=3)
    assert not layer.weight[3].any()
    layer = Embedding(10, 4, 3, False, None, "emb")
    assert not layer.weight[3].any()
    with pytest.raises(NotImplementedError):
        Embedding(10, 4, sparse=True)
    with pytest.raises(NotImplementedError):
        Embedding(10, 4, None, False, object())


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


def _copy_params(jlayer, tlayer):
    """The reference layer's parameters into the port's, by name."""
    state = {k: torch.from_numpy(np.asarray(v._data).copy())
             for k, v in jlayer.state_dict().items()}
    tlayer.load_state_dict(state, strict=True)


def test_fused_attention_binds_positional_arguments_as_the_reference():
    """FusedMultiHeadAttention(64, 4, 0.0, 0.0, None, None, True) is a
    pre-norm layer in both packages (True is `normalize_before`); the
    outputs agree within 1e-5 on the reference's weights."""
    args = (64, 4, 0.0, 0.0, None, None, True)
    jl = JINC.FusedMultiHeadAttention(*args)
    tl = TINC.FusedMultiHeadAttention(*args, device="cpu")
    assert jl.normalize_before and tl.normalize_before
    _copy_params(jl, tl)
    x = np.random.RandomState(5).randn(2, 8, 64).astype(np.float32)
    want = jl(paddle.to_tensor(x))
    got = tl(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want._data),
                               rtol=1e-5, atol=1e-5)
    tl = TINC.FusedMultiHeadAttention(64, 4, kdim=64, vdim=64,
                                      need_weights=False, epsilon=1e-6,
                                      nranks=1, ring_id=-1, name="a",
                                      qkv_bias_attr=False, device="cpu")
    assert tl.qkv_bias is None and tl.linear_bias is not None
    for kw in (dict(kdim=32), dict(need_weights=True), dict(nranks=2),
               dict(ring_id=0), dict(qkv_weight_attr=object()),
               dict(ln_scale_attr=False)):
        with pytest.raises(NotImplementedError):
            TINC.FusedMultiHeadAttention(64, 4, device="cpu", **kw)


def test_fused_feedforward_and_encoder_take_the_reference_arguments():
    """FusedFeedForward's `*_attr`, `nranks`, `ring_id` and `name` in the
    reference's positions, and the encoder layer's `weight_attr` /
    `bias_attr`: outputs within 1e-5 of the reference's on its weights."""
    x = np.random.RandomState(6).randn(2, 8, 32).astype(np.float32)
    args = (32, 64, 0.0, 1e-5, "gelu", 0.0, True) + (None,) * 8 + \
        (1, -1, "ffn")
    jl = JINC.FusedFeedForward(*args)
    tl = TINC.FusedFeedForward(*args, device="cpu")
    _copy_params(jl, tl)
    np.testing.assert_allclose(
        tl(torch.from_numpy(x)).detach().numpy(),
        np.asarray(jl(paddle.to_tensor(x))._data), rtol=1e-5, atol=1e-5)
    args = (32, 4, 64, 0.0, "relu", None, None, False, None, None)
    jl = JINC.FusedTransformerEncoderLayer(*args)
    tl = TINC.FusedTransformerEncoderLayer(*args, device="cpu")
    _copy_params(jl, tl)
    np.testing.assert_allclose(
        tl(torch.from_numpy(x)).detach().numpy(),
        np.asarray(jl(paddle.to_tensor(x))._data), rtol=1e-5, atol=1e-5)
    nb = TINC.FusedTransformerEncoderLayer(32, 4, 64, bias_attr=False,
                                           device="cpu")
    assert nb.ffn.linear1_bias is None and nb.fused_attn.qkv_bias is None
    assert torch.isfinite(nb(torch.from_numpy(x))).all()
    for kw in (dict(weight_attr=object()), dict(bias_attr=object())):
        with pytest.raises(NotImplementedError):
            TINC.FusedTransformerEncoderLayer(32, 4, 64, device="cpu", **kw)
    with pytest.raises(NotImplementedError):
        TINC.FusedFeedForward(32, 64, nranks=2, device="cpu")


def test_seed_takes_s():
    paddle.seed(s=3)
    g = ptt.seed(s=3)
    assert ptt.get_seed() == 3 and g is ptt.seed(3)


@pytest.mark.parametrize("neox", [True, False])
@pytest.mark.parametrize("batched", [False, True])
def test_apply_rope_both_styles_match_reference(neox, batched):
    """The rotate-half (neox) and interleaved (GPT-J) pairs, with one table
    or per-row tables, within 1e-6 (f32)."""
    rng = np.random.RandomState(7)
    x = rng.randn(2, 5, 3, 8).astype(np.float32)
    shape = (2, 5, 4) if batched else (5, 4)
    cos = rng.randn(*shape).astype(np.float32)
    sin = rng.randn(*shape).astype(np.float32)
    # the reference's apply_rope works on jax arrays
    want = JROPE.apply_rope(*(np.asarray(a) for a in (x, cos, sin)),
                            neox=neox)
    got = TF.apply_rope(*(torch.from_numpy(a) for a in (x, cos, sin)),
                        neox=neox)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("tables", [False, True])
@pytest.mark.parametrize("with_v", [False, True])
@pytest.mark.parametrize("neox", [True, False])
def test_fused_rotary_position_embedding_matches_reference(tables, with_v,
                                                           neox):
    rng = np.random.RandomState(8)
    q, k, v = (rng.randn(2, 6, 2, 8).astype(np.float32) for _ in range(3))
    kw = dict(use_neox_rotary_style=neox, position_ids=None, name="r")
    if tables:
        ang = rng.randn(6, 8).astype(np.float32)
        kw.update(sin=np.sin(ang), cos=np.cos(ang))
    jkw = {k_: paddle.to_tensor(a) if isinstance(a, np.ndarray) else a
           for k_, a in kw.items()}
    tkw = {k_: torch.from_numpy(a) if isinstance(a, np.ndarray) else a
           for k_, a in kw.items()}
    want = JROPE.fused_rotary_position_embedding(
        paddle.to_tensor(q), paddle.to_tensor(k),
        paddle.to_tensor(v) if with_v else None, **jkw)
    for fn in (TF.fused_rotary_position_embedding,
               TINC.functional.fused_rotary_position_embedding):
        got = fn(torch.from_numpy(q), torch.from_numpy(k),
                 torch.from_numpy(v) if with_v else None, **tkw)
        assert (got[2] is None) == (want[2] is None) == (not with_v)
        for g, w in zip(got, want):
            if w is not None:
                np.testing.assert_allclose(g.numpy(), np.asarray(w._data),
                                           rtol=1e-6, atol=1e-6)


def test_refresh_params_serves_the_reloaded_weights():
    """An engine whose model's weights are replaced (`load_llama_state`)
    and then `refresh_params()` serves the new weights: its greedy streams
    equal a fresh engine's on them, and differ from its streams before."""
    from paddle_tpu_torch.weights import llama_state_to_numpy, \
        load_llama_state
    from torch_parity import serve, serving_pair

    _, tm = serving_pair(seed=0)
    _, other = serving_pair(seed=1)
    kw = dict(max_batch=2, max_seq_len=32, page_size=8,
              decode_strategy="greedy_search", device="cpu")
    rng = np.random.RandomState(9)
    prompts = [rng.randint(0, 97, (n,)) for n in (5, 7)]
    eng = ServingEngine(tm, **kw)
    before = serve(eng, prompts, (8, 8))
    load_llama_state(tm, llama_state_to_numpy(other))
    assert eng.refresh_params() is None
    after = serve(eng, prompts, (8, 8))
    fresh = serve(ServingEngine(other, **kw), prompts, (8, 8))
    assert after == fresh and after != before
    assert JaxServingEngine.refresh_params.__doc__


def test_plain_layers_take_name():
    x = torch.randn(4, 6)
    d = TNN.Dropout(0.5, None, "upscale_in_train", "drop")
    d.eval()
    assert torch.equal(d(x), x)
    q = TQ.WeightOnlyLinear(64, 128, "weight_only_int8", -1, "q",
                            device="cpu")
    jq = JQ.WeightOnlyLinear(64, 128, "weight_only_int8", -1, "q")
    assert tuple(q.weight_scale.shape) == tuple(jq.weight_scale.shape)
