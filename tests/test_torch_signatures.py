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

# the tensor-parallel slice's public names: fleet, the strategy, the
# mp_layers, the sequence-parallel linears and ops, the meta_parallel
# wrappers and the RNG tracker
import paddle_tpu.distributed.fleet as JFL  # noqa: E402
import paddle_tpu.distributed.fleet.layers.mpu.random as JMPR  # noqa: E402
import paddle_tpu.distributed.fleet.utils.sequence_parallel_utils as JSPU  # noqa: E402,E501
import paddle_tpu.framework.random as JRND  # noqa: E402
import paddle_tpu_torch.distributed.fleet as TFL  # noqa: E402
import paddle_tpu_torch.distributed.fleet.layers.mpu.random as TMPR  # noqa: E402,E501
import paddle_tpu_torch.distributed.fleet.utils.sequence_parallel_utils as TSPU  # noqa: E402,E501
import paddle_tpu_torch.framework.random as TRND  # noqa: E402
from paddle_tpu.distributed.fleet import meta_parallel as JMP  # noqa: E402
from paddle_tpu.distributed.fleet.layers import mpu as JMPU  # noqa: E402
from paddle_tpu.distributed.fleet.meta_parallel import \
    hybrid_optimizer as JHO  # noqa: E402
from paddle_tpu_torch.distributed.fleet import meta_parallel as TMP  # noqa: E402,E501
from paddle_tpu_torch.distributed.fleet.layers import mpu as TMPU  # noqa: E402
from paddle_tpu_torch.distributed.fleet.meta_parallel import \
    hybrid_optimizer as THO  # noqa: E402
for _fn in ("init", "distributed_model", "distributed_optimizer",
            "get_hybrid_communicate_group", "worker_index", "worker_num",
            "is_first_worker", "is_worker", "is_server", "worker_endpoints",
            "barrier_worker", "init_worker", "stop_worker", "init_server",
            "run_server"):
    PAIRS[f"fleet.{_fn}"] = (getattr(JFL, _fn), getattr(TFL, _fn))
for _fn in ("save", "load_model"):
    PAIRS[f"fleet.Fleet.{_fn}"] = (getattr(JFL.Fleet, _fn),
                                   getattr(TFL.Fleet, _fn))
for _cls in ("UserDefinedRoleMaker", "PaddleCloudRoleMaker"):
    PAIRS[f"fleet.{_cls}"] = (getattr(JFL, _cls).__init__,
                              getattr(TFL, _cls).__init__)
for _fn in ("all_reduce", "barrier", "get_file_shard"):
    PAIRS[f"fleet.util.{_fn}"] = (getattr(JFL.UtilBase, _fn),
                                  getattr(TFL.UtilBase, _fn))
for _cls in ("ColumnParallelLinear", "RowParallelLinear",
             "VocabParallelEmbedding", "ParallelCrossEntropy"):
    PAIRS[f"mpu.{_cls}"] = (getattr(JMPU, _cls).__init__,
                            getattr(TMPU, _cls).__init__)
    PAIRS[f"mpu.{_cls}.forward"] = (getattr(JMPU, _cls).forward,
                                    getattr(TMPU, _cls).forward)
for _cls in ("ColumnSequenceParallelLinear", "RowSequenceParallelLinear"):
    PAIRS[f"sp.{_cls}"] = (getattr(JSPU, _cls).__init__,
                           getattr(TSPU, _cls).__init__)
for _cls in ("ScatterOp", "GatherOp", "AllGatherOp", "ReduceScatterOp"):
    PAIRS[f"sp.{_cls}.apply"] = (getattr(JSPU, _cls).apply,
                                 getattr(TSPU, _cls).apply)
for _fn in ("mark_as_sequence_parallel_parameter",
            "register_sequence_parallel_allreduce_hooks"):
    PAIRS[f"sp.{_fn}"] = (getattr(JSPU, _fn), getattr(TSPU, _fn))
for _fn in ("model_parallel_random_seed", "get_rng_state_tracker"):
    PAIRS[f"random.{_fn}"] = (getattr(JRND, _fn), getattr(TRND, _fn))
for _fn in ("add", "reset", "get_states_tracker", "set_states_tracker",
            "rng_state"):
    PAIRS[f"RNGStatesTracker.{_fn}"] = (
        getattr(JRND.RNGStatesTracker, _fn),
        getattr(TRND.RNGStatesTracker, _fn))
for _fn in ("dropout", "determinate_seed"):
    PAIRS[f"mpu.random.{_fn}"] = (getattr(JMPR, _fn), getattr(TMPR, _fn))
PAIRS.update({
    "fleet.DistributedStrategy": (JFL.DistributedStrategy.__init__,
                                  TFL.DistributedStrategy.__init__),
    "HybridParallelOptimizer": (JMP.HybridParallelOptimizer.__init__,
                                TMP.HybridParallelOptimizer.__init__),
    "HybridParallelOptimizer.minimize": (
        JMP.HybridParallelOptimizer.minimize,
        TMP.HybridParallelOptimizer.minimize),
    "HybridParallelClipGrad": (JHO.HybridParallelClipGrad.__init__,
                               THO.HybridParallelClipGrad.__init__),
    "TensorParallel": (JMP.TensorParallel.__init__,
                       TMP.TensorParallel.__init__),
})

# the ZeRO and auto-parallel slice's public names
import paddle_tpu.distributed as JDIST  # noqa: E402
import paddle_tpu.distributed.auto_parallel as JAP  # noqa: E402
import paddle_tpu.distributed.fleet.meta_parallel.sharding.sharding_optimizer as JSO  # noqa: E402,E501
import paddle_tpu.distributed.sharding_utils as JSU  # noqa: E402
import paddle_tpu_torch.distributed as TDIST  # noqa: E402
import paddle_tpu_torch.distributed.auto_parallel as TAP  # noqa: E402
import paddle_tpu_torch.distributed.fleet.meta_parallel.sharding.sharding_optimizer as TSO  # noqa: E402,E501
import paddle_tpu_torch.distributed.sharding_utils as TSU  # noqa: E402
for _fn in ("group_sharded_parallel", "zero_axis_for", "zero_extend_spec",
            "shard_spec_for"):
    PAIRS[f"sharding.{_fn}"] = (getattr(JSO, _fn), getattr(TSO, _fn))
for _fn in ("__init__", "step", "minimize", "state_spec_pytree"):
    PAIRS[f"DygraphShardingOptimizer.{_fn}"] = (
        getattr(JSO.DygraphShardingOptimizer, _fn),
        getattr(TSO.DygraphShardingOptimizer, _fn))
for _fn in ("shard_tensor", "reshard", "shard_layer", "dtensor_from_fn",
            "shard_op", "set_mesh", "get_mesh"):
    PAIRS[f"auto_parallel.{_fn}"] = (getattr(JAP, _fn), getattr(TAP, _fn))
for _cls in ("ProcessMesh", "DistAttr", "Shard", "Partial"):
    PAIRS[f"auto_parallel.{_cls}"] = (getattr(JAP, _cls).__init__,
                                      getattr(TAP, _cls).__init__)
PAIRS["auto_parallel.ProcessMesh.get_dim_size"] = (
    JAP.ProcessMesh.get_dim_size, TAP.ProcessMesh.get_dim_size)
for _fn in ("clean_spec", "in_manual_region", "shard_tensor",
            "mark_sharding", "get_param_spec"):
    PAIRS[f"sharding_utils.{_fn}"] = (getattr(JSU, _fn), getattr(TSU, _fn))
for _fn in ("shard_tensor", "mark_sharding", "get_param_spec", "split",
            "named_sharding", "reshard", "shard_layer", "dtensor_from_fn",
            "shard_op"):
    PAIRS[f"distributed.{_fn}"] = (getattr(JDIST, _fn), getattr(TDIST, _fn))
PAIRS["distributed.mesh.named_sharding"] = (JDM.named_sharding,
                                            TDM.named_sharding)
PAIRS["meta_parallel.DygraphShardingOptimizer"] = (
    JMP.DygraphShardingOptimizer.__init__, TMP.DygraphShardingOptimizer.__init__)

# the pipeline slice's public names (the p2p functions of
# `pp_utils/p2p_communication.py` have no counterpart in the reference,
# whose stages exchange by `ppermute`)
import paddle_tpu.distributed.pipeline as JPIPE  # noqa: E402
import paddle_tpu.models.trainer as JTRAIN  # noqa: E402
import paddle_tpu_torch.distributed.pipeline as TPIPE  # noqa: E402
import paddle_tpu_torch.models.trainer as TTRAIN  # noqa: E402
for _fn in ("microbatch", "spmd_pipeline", "spmd_pipeline_1f1b",
            "spmd_pipeline_vpp"):
    PAIRS[f"pipeline.{_fn}"] = (getattr(JPIPE, _fn), getattr(TPIPE, _fn))
PAIRS["build_pipeline_train_step"] = (JTRAIN.build_pipeline_train_step,
                                      TTRAIN.build_pipeline_train_step)
for _cls in ("PipelineLayer", "LayerDesc", "SharedLayerDesc",
             "PipelineParallel"):
    PAIRS[f"meta_parallel.{_cls}"] = (getattr(JMP, _cls).__init__,
                                      getattr(TMP, _cls).__init__)
for _cls, _fn in (("PipelineParallel", "train_batch"),
                  ("PipelineParallel", "eval_batch"),
                  ("PipelineParallel", "forward_backward_pipeline"),
                  ("PipelineLayer", "get_stage_layers"),
                  ("PipelineLayer", "forward"),
                  ("LayerDesc", "build_layer")):
    PAIRS[f"meta_parallel.{_cls}.{_fn}"] = (
        getattr(getattr(JMP, _cls), _fn), getattr(getattr(TMP, _cls), _fn))
PAIRS["mesh.HybridCommunicateGroup.get_rank_from_stage"] = (
    JDM.HybridCommunicateGroup.get_rank_from_stage,
    TDM.HybridCommunicateGroup.get_rank_from_stage)

# ROADMAP Queue 3's two faults of the re-anchor after the pipeline slice:
# LlamaConfig's positional order and the kernel entries' tile-size
# positions (a tile size takes None in the port)
import paddle_tpu.kernels.flash_attention as JKFA  # noqa: E402
import paddle_tpu.kernels.matmul as JKMM  # noqa: E402
import paddle_tpu.kernels.quant_matmul as JKQM  # noqa: E402
import paddle_tpu.kernels.rms_norm as JKRMS  # noqa: E402
import paddle_tpu_torch.kernels.flash_attention as TKFA  # noqa: E402
import paddle_tpu_torch.kernels.matmul as TKMM  # noqa: E402
import paddle_tpu_torch.kernels.quant_matmul as TKQM  # noqa: E402
import paddle_tpu_torch.kernels.rms_norm as TKRMS  # noqa: E402
PAIRS.update({
    "LlamaConfig": (JaxLlamaConfig.__init__, LlamaConfig.__init__),
    "kernels.rms_norm.rms_norm": (JKRMS.rms_norm, TKRMS.rms_norm),
    "kernels.rms_norm.supports": (JKRMS.supports, TKRMS.supports),
    "kernels.flash_attention.flash_attention_bshd": (
        JKFA.flash_attention_bshd, TKFA.flash_attention_bshd),
    "kernels.flash_attention.flash_attention_with_lse_bshd": (
        JKFA.flash_attention_with_lse_bshd,
        TKFA.flash_attention_with_lse_bshd),
    "kernels.flash_attention.flash_attn_unpadded": (
        JKFA.flash_attn_unpadded, TKFA.flash_attn_unpadded),
    "kernels.flash_attention.supports": (JKFA.supports, TKFA.supports),
    "kernels.matmul.matmul_fused": (JKMM.matmul_fused, TKMM.matmul_fused),
    "kernels.matmul.supports": (JKMM.supports, TKMM.supports),
    "kernels.quant_matmul.supports": (JKQM.supports, TKQM.supports),
})

# distributed/checkpoint.py
import paddle_tpu.distributed.checkpoint as JCK  # noqa: E402
import paddle_tpu_torch.distributed.checkpoint as TCK  # noqa: E402
for _fn in ("save_state_dict", "load_state_dict", "trainer_state_snapshot",
            "apply_trainer_state", "save_model_state", "load_model_state",
            "_leaf_checksums"):
    PAIRS[f"checkpoint.{_fn}"] = (getattr(JCK, _fn), getattr(TCK, _fn))
for _fn in ("__init__", "save", "restore", "restore_trainer_state",
            "is_committed", "committed_steps", "last_known_good", "manifest",
            "latest_step", "all_steps", "should_save", "wait", "close"):
    PAIRS[f"checkpoint.CheckpointManager.{_fn}"] = (
        getattr(JCK.CheckpointManager, _fn),
        getattr(TCK.CheckpointManager, _fn))

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
             "WeightOnlyLinear": ["device"],
             # a chunk of the interleaved schedule's stage
             "meta_parallel.PipelineLayer.forward": ["chunk_id"],
             # PaddleNLP's fields, after the reference's
             "LlamaConfig": ["virtual_pp_degree", "sequence_parallel"],
             # keyword only: the port's own arguments of its kernel entries
             "kernels.rms_norm.rms_norm": ["with_rstd"],
             "kernels.rms_norm.supports": ["dtype", "weight"],
             "kernels.flash_attention.supports": ["dtype"],
             "kernels.matmul.matmul_fused": ["tile"],
             "kernels.matmul.supports": ["dtype"]}
# the tensor-parallel layers' dtype and device
PORT_ONLY.update({n: ["dtype", "device"] for n in (
    "mpu.ColumnParallelLinear", "mpu.RowParallelLinear",
    "mpu.VocabParallelEmbedding", "sp.ColumnSequenceParallelLinear",
    "sp.RowSequenceParallelLinear")})
PORT_ONLY.update({f"{c}.__init__": _LAYER for c in (
    "MultiHeadAttention", "TransformerEncoderLayer",
    "TransformerDecoderLayer", "Transformer", "FusedMultiTransformer",
    "FusedLinear", "FusedEcMoe", "FusedMultiHeadAttention",
    "FusedFeedForward", "FusedTransformerEncoderLayer")})




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
    # mp_group is taken: the tensor-parallel group, here the "tp" axis of
    # no mesh, a group of one rank (the parallel path:
    # tests/test_torch_mp_layers.py)
    one = ParallelCrossEntropy(mp_group="tp", ignore_index=2)
    assert one.world_size == 1
    np.testing.assert_array_equal(
        one(torch.from_numpy(logits), torch.from_numpy(lab)).numpy(),
        got.numpy())


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


def test_llama_config_binds_positions_as_the_reference():
    """The thirteenth positional argument is `scan_layers` in both
    packages; the port-only fields follow `dtype`."""
    args = (128, 64, 128, 2, 4, 4, 256, 1e-6, 10000.0, False, False, False,
            True)
    ref, port = JaxLlamaConfig(*args), LlamaConfig(*args)
    assert ref.scan_layers is True and port.scan_layers is True
    assert port.sequence_parallel is False
    for f in ("vocab_size", "hidden_size", "num_key_value_heads",
              "rms_norm_eps", "use_recompute", "cp_zigzag_stream",
              "fused_ce_chunks", "dtype"):
        assert getattr(port, f) == getattr(ref, f), f
    full = args + (4, "bfloat16")
    assert LlamaConfig(*full).dtype == JaxLlamaConfig(*full).dtype


def test_kernel_entries_bind_a_reference_shaped_call():
    """`rms_norm(x, w, 1e-6, None)` returns y in both packages (the port's
    fourth position is the reference's `block_rows`, not `with_rstd`);
    the support tests answer a reference-shaped call by shape."""
    rng = np.random.RandomState(3)
    x = rng.randn(8, 256).astype(np.float32)
    w = (1.0 + 0.1 * rng.randn(256)).astype(np.float32)
    want = np.asarray(JKRMS.rms_norm(x, w, 1e-6, None))
    got = TKRMS.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6,
                         None)
    assert isinstance(got, torch.Tensor)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert TKRMS.supports(256, 512) == JKRMS.supports(256, 512) is True
    assert TKFA.supports(4096, 4096, 128) == \
        JKFA.supports(4096, 4096, 128) is True
    assert TKMM.supports(8, 256, 256) == JKMM.supports(8, 256, 256) is True
    assert TKQM.supports(8, 256, 256, "int8", -1) == \
        JKQM.supports(8, 256, 256, "int8", -1) is True


@pytest.mark.parametrize("call", [
    lambda x: TKRMS.rms_norm(x, None, 1e-6, 256),
    lambda x: TKRMS.supports(8, 256, 128),
    lambda x: TKFA.supports(256, 256, 128, 128),
    lambda x: TKFA.supports(256, 256, 128, None, 128),
    lambda x: TKFA.flash_attention_bshd(x, x, x, False, None, 128),
    lambda x: TKFA.flash_attention_with_lse_bshd(x, x, x, True, None, None,
                                                 256),
    lambda x: TKFA.flash_attn_unpadded(x[0], x[0], x[0], [0, 4], [0, 4], 4,
                                       4, None, 0.0, False, False, 128),
    lambda x: TKMM.matmul_fused(x[0, 0], x[0, 0].T, 256),
    lambda x: TKMM.supports(8, 256, 256, 128),
    lambda x: TKQM.supports(8, 256, 256, "int8", -1, 128, 128),
])
def test_a_tile_size_raises_naming_the_difference(call):
    x = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError, match="TPU tile sizes"):
        call(x)


# ---------------------------------------------------------------------------
# the Paddle-shaped core (ROADMAP Queue 1 item 5): every public function and
# class the reference's core modules define, by module, and the package
# root's names
# ---------------------------------------------------------------------------
CORE_MODULES = (
    "ops.activation", "ops.creation", "ops.indexing", "ops.inplace",
    "ops.linalg", "ops.logic", "ops.manipulation", "ops.math",
    "ops.random_ops", "ops.reduction", "ops.search", "tensor", "autograd",
    "autograd.tape", "autograd.py_layer", "autograd.functional",
    "framework.dtype", "framework.device", "framework.config", "device",
    "linalg")
# the reference's tape internals and method installers, which torch's
# autograd graph and the port's function-only surface replace (ROADMAP,
# deliberate differences); the jax device lookup
CORE_NOT_PORTED = {"autograd.tape.InputRef", "autograd.tape.TapeNode",
                   "ops.inplace.install_tensor_inplace_methods",
                   "framework.device.current_jax_device"}


def _core_pairs():
    out = {}
    for mod in CORE_MODULES:
        ref = importlib.import_module(f"paddle_tpu.{mod}")
        port = importlib.import_module(f"paddle_tpu_torch.{mod}")
        for n in dir(ref):
            obj = getattr(ref, n)
            if n.startswith("_") or not (inspect.isfunction(obj)
                                         or inspect.isclass(obj)):
                continue
            origin = obj.__module__
            if origin != ref.__name__ and not (
                    mod in ("autograd", "device", "linalg")
                    and origin.startswith("paddle_tpu.")):
                continue  # imported there from another module
            key = f"{mod}.{n}"
            if key in CORE_NOT_PORTED:
                continue
            out[key] = (obj, getattr(port, n, None))
    return out


CORE_PAIRS = _core_pairs()
for _key, (_ref, _port) in CORE_PAIRS.items():
    if _port is not None and not (inspect.isclass(_ref)
                                  and _ref.__init__ is object.__init__):
        PAIRS[_key] = (_ref.__init__, _port.__init__) \
            if inspect.isclass(_ref) else (_ref, _port)
# the port's own: the device a converted operand goes to. DType and Tensor
# are torch.dtype and torch.Tensor, whose constructors are torch's
PORT_ONLY["tensor.as_array"] = ["device"]
PAIRS.pop("framework.dtype.DType", None)
PAIRS.pop("tensor.Tensor", None)


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_parameter_names_match_the_reference(name):
    ref, port = PAIRS[name]
    extra = PORT_ONLY.get(name, [])
    names = _names(port)
    assert names[len(names) - len(extra):] == extra
    assert names[:len(names) - len(extra)] == _names(ref)


def test_every_core_function_of_the_reference_is_ported():
    missing = sorted(k for k, (_, port) in CORE_PAIRS.items()
                     if port is None)
    assert missing == []
    assert len(CORE_PAIRS) > 500


# the reference root's names that the port's root still lacks, each with
# the ROADMAP item that ports it
ROOT_MISSING = {"Model": "8 A", "summary": "8 A", "flops": "8 A",
                "enable_static": "8 B", "disable_static": "8 B"}
# the reference root's subpackages that the port lacks, by item
ROOT_MISSING_MODULES = {
    "audio": "8 B", "callbacks": "8 A", "distribution": "8 B",
    "fft": "8 B", "hapi": "8 A", "metric": "8 A", "observability": "7",
    "profiler": "8 B", "quantization": "2", "signal": "8 B",
    "sparse": "8 B", "static": "8 B", "text": "8 B", "utils": "8 B",
    "vision": "8 A"}


def _root_names(pkg):
    return {n: getattr(pkg, n) for n in dir(pkg) if not n.startswith("_")}


def test_the_root_holds_the_reference_s_core_names():
    """Every public name of the reference's root that is not a module
    (the core's ops, tensor, autograd, dtypes, places and config, and the
    names the root defines itself) is at the port's root with the
    reference's parameter names and order, but the ones ROOT_MISSING
    lists."""
    ref, port = _root_names(paddle), _root_names(ptt)
    missing, differ = [], []
    for n, obj in ref.items():
        if inspect.ismodule(obj):
            continue
        if n not in port:
            missing.append(n)
            continue
        if not callable(obj) or isinstance(obj, paddle.DType) or \
                n in ("DType", "Tensor"):
            continue
        if inspect.isclass(obj) and obj.__init__ is object.__init__:
            continue
        try:
            want = _names(obj.__init__ if inspect.isclass(obj) else obj)
        except (TypeError, ValueError):
            continue
        got_obj = port[n]
        got = _names(got_obj.__init__ if inspect.isclass(got_obj)
                     else got_obj)
        extra = PORT_ONLY.get(f"tensor.{n}", [])
        if got[:len(got) - len(extra)] != want:
            differ.append((n, want, got))
    assert sorted(missing) == sorted(ROOT_MISSING)
    assert differ == []


def test_the_root_s_missing_subpackages_are_queued():
    """The subpackages the reference's root imports (its `from . import
    ...` lines: what other tests import adds more to its namespace) are
    at the port's root, but the ones ROOT_MISSING_MODULES lists."""
    import ast

    tree = ast.parse(inspect.getsource(paddle))
    imported = {a.asname or a.name for node in tree.body
                if isinstance(node, ast.ImportFrom) and node.level == 1
                for a in node.names
                if inspect.ismodule(getattr(paddle, a.asname or a.name,
                                            None))}
    port = _root_names(ptt)
    missing = {n for n in imported if not n.startswith("_")
               and n not in port}
    assert missing == set(ROOT_MISSING_MODULES)
    for n in ("amp", "autograd", "device", "incubate", "inference", "io",
              "jit", "linalg", "ops", "optimizer", "tensor", "nn",
              "distributed", "framework"):
        assert inspect.ismodule(port[n]), n
