"""The port's fleet facade against the JAX package's, on the CPU: the
worker and role API at world 1 (the reference's
`test_api_tail_r3b.py::test_fleet_worker_api`), the strategy's gradient
merge wiring and its refused toggles (`test_gradient_merge.py:78-121`),
and, in a group of two gloo ranks (`torch_tp_workers.fleet_main`),
`fleet.init` at each degree with what `distributed_model` and
`distributed_optimizer` return: `DataParallel` at dp 2, `TensorParallel`
at mp 2, `PipelineParallel` at pp 2 (over a LLaMA built under the mesh),
the model itself otherwise, and `DygraphShardingOptimizer` at sharding 2
(ZeRO stage 1, as the reference's `fleet.distributed_optimizer` gives);
context parallelism (sep) raises, naming its ROADMAP item; `fleet.save` /
`load_model` write and read one checkpoint across the ranks."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.distributed.fleet.meta_parallel.hybrid_optimizer import \
    HybridParallelOptimizer as JaxHPO
from paddle_tpu_torch.distributed import fleet
from paddle_tpu_torch.distributed.fleet import meta_parallel
from paddle_tpu_torch.distributed.fleet.meta_parallel import \
    HybridParallelOptimizer
from paddle_tpu_torch.models import build_train_step
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.optimizer import AdamW
from torch_dist_workers import run_group
from torch_tp_workers import fleet_main

FILES = ["a", "b", "c", "d", "e"]
TOGGLES = ["dgc", "localsgd", "find_unused_parameters", "asp",
           "fp16_allreduce"]


@pytest.fixture(scope="module")
def ranks():
    return sorted(run_group(fleet_main, 2, FILES), key=lambda r: r["rank"])


def test_worker_api_at_world_1_matches_the_reference():
    for f in (jfleet, fleet):
        assert f.worker_index() == 0 and f.worker_num() >= 1
        assert f.is_first_worker() and f.is_worker() and not f.is_server()
        f.init_worker()
        f.stop_worker()
        f.barrier_worker()
        with pytest.raises(NotImplementedError):
            f.init_server()
        with pytest.raises(NotImplementedError):
            f.run_server()
        rm = f.PaddleCloudRoleMaker()
        assert rm.worker_index() == 0 and rm.is_worker()
        ud = f.UserDefinedRoleMaker(current_id=2, worker_num=4)
        assert (ud.worker_index(), ud.worker_num(), ud.is_first_worker()) \
            == (2, 4, False)
        assert f.util.get_file_shard(["a", "b", "c"]) == ["a", "b", "c"]
        np.testing.assert_allclose(
            f.util.all_reduce(np.array([1.0, 2.0], "float32")), [1.0, 2.0])
        assert f.worker_endpoints(to_string=True) == \
            jfleet.worker_endpoints(to_string=True)


def test_worker_api_over_two_ranks(ranks):
    assert [r["rank"] for r in ranks] == [0, 1]
    assert all(r["num"] == 2 and r["endpoints"] == 2 for r in ranks)
    assert [r["first"] for r in ranks] == [True, False]
    # contiguous shards, the earlier worker taking the remainder
    assert [r["shard"] for r in ranks] == [FILES[:3], FILES[3:]]
    for r in ranks:
        np.testing.assert_allclose(r["reduced"], [3.0, 6.0])


@pytest.mark.parametrize("degree,mesh,model,mode", [
    ("dp", ("dp",), "DataParallel", "data"),
    ("tp", ("tp",), "TensorParallel", "hybrid"),
    ("pp", ("pp",), "PipelineParallel", "hybrid"),
    ("sharding", ("sharding",), "Linear", "sharding"),
    ("sep", ("sep",), "Linear", "single")])
def test_distributed_model_and_optimizer_by_degree(ranks, degree, mesh,
                                                   model, mode):
    for r in ranks:
        got = r[degree]
        assert got["mesh"] == mesh and got["mode"] == mode
        assert got["model"].startswith(model), got["model"]
        if degree == "sharding":
            # the reference's wrapper: no gradient merge from the strategy
            assert got["optimizer"] == ("DygraphShardingOptimizer", 1, True)
        else:
            # the strategy's gradient merge rides on the optimizer
            assert got["optimizer"] == ("HybridParallelOptimizer", 3, False)
    want_refusal = {"dp": None, "tp": None, "pp": None,
                    "sharding": None, "sep": "context_parallel.py"}
    for r in ranks:
        msg = r[degree]["train_step"]
        if want_refusal[degree] is None:
            assert msg is None, msg
        else:
            assert want_refusal[degree] in msg and "item 4" in msg, msg


@pytest.mark.parametrize("degree", ["dp", "tp"])
def test_optimizer_step_leaves_the_dp_average_to_the_data_parallel_model(
        ranks, degree):
    """In data-parallel mode `DataParallel.sync_gradients` averages, so the
    wrapper's `step` does not average again; at tp 2 there is no dp axis
    to average over. Each rank's gradient is its own after `step`."""
    for r in ranks:
        np.testing.assert_array_equal(r[degree]["step_grad"],
                                      np.full(3, r["rank"] + 1.0))


def test_checkpoints_raise_naming_the_module(ranks):
    """Once refused (until `distributed/checkpoint.py`), `fleet.save` /
    `load_model` now write and read one checkpoint across the ranks: a
    replicated weight is written once (rank 0's file), read back equal on
    every rank (tests/test_torch_checkpoint.py holds the sharded cases)."""
    for r in ranks:
        assert r["checkpoint"]["equal"]
        assert r["checkpoint"]["files"] == [
            "metadata.json", "rank0.crc.json", "rank0.pt", "rank1.crc.json"]


def test_distributed_model_without_degrees_is_the_model():
    net = torch.nn.Linear(2, 2)
    assert fleet.Fleet().distributed_model(net) is net


@pytest.mark.parametrize("cls", ["PipelineParallel", "PipelineLayer"])
def test_unported_meta_parallel_classes_raise(cls):
    """(The name is kept from when both classes raised.) Both construct
    without a "pp" axis: a `PipelineLayer` builds every stage, as the
    reference's does, and runs them in order; `PipelineParallel` over it
    reads `pipeline_configs` and runs `train_batch` on one rank. A
    LayerDesc of a non-layer raises the reference's TypeError."""
    torch.manual_seed(0)
    descs = [meta_parallel.LayerDesc(torch.nn.Linear, 4, 4), torch.tanh,
             meta_parallel.LayerDesc(torch.nn.Linear, 4, 2)]
    with pytest.raises(TypeError):
        meta_parallel.LayerDesc(torch.tanh)
    layer = meta_parallel.PipelineLayer(
        descs, num_stages=2, loss_fn=torch.nn.functional.cross_entropy)
    x, y = torch.randn(4, 4), torch.tensor([0, 1, 1, 0])
    want = layer.run_function[2][0](torch.tanh(layer.run_function[0][0](x)))
    torch.testing.assert_close(layer(x), want)
    assert [len(layer.get_stage_layers(s)) for s in (0, 1)] == [1, 2]
    if cls == "PipelineLayer":
        assert layer._segments == [0, 1, 1]
        return
    s = fleet.DistributedStrategy()
    s.pipeline_configs = dict(s.pipeline_configs, accumulate_steps=2)
    pp = getattr(meta_parallel, cls)(layer, None, s)
    assert (pp.accumulate_steps, pp.micro_batch_size) == (2, 1)
    opt = torch.optim.SGD(layer.parameters(), lr=0.0)
    opt.clear_grad = opt.zero_grad
    loss = pp.train_batch((x, y), opt)
    want = 0.5 * (torch.nn.functional.cross_entropy(layer(x[:2]), y[:2])
                  + torch.nn.functional.cross_entropy(layer(x[2:]), y[2:]))
    torch.testing.assert_close(loss, want.detach())


@pytest.mark.parametrize("merge", [True, False])
def test_strategy_wires_gradient_merge_as_the_reference(merge):
    strategies = [jfleet.DistributedStrategy(), fleet.DistributedStrategy()]
    for s in strategies:
        s.gradient_merge = merge
        s.gradient_merge_configs = {"k_steps": 4, "avg": False}
    jm = paddle.nn.Linear(2, 2)
    want = JaxHPO(paddle.optimizer.AdamW(
        learning_rate=1e-3, parameters=jm.parameters()), None,
        strategies[0])
    got = HybridParallelOptimizer(AdamW(
        learning_rate=1e-3, parameters=torch.nn.Linear(2, 2).parameters()),
        None, strategies[1])
    assert (got._gradient_merge_k, got._gradient_merge_avg) == \
        (want._gradient_merge_k, want._gradient_merge_avg)


def test_merged_steps_through_the_wrapper_apply_on_the_kth_call():
    """build_train_step reads k from HybridParallelOptimizer: no update
    before the 3rd call; the wrapper's step count is the inner
    optimizer's."""
    s = fleet.DistributedStrategy()
    s.gradient_merge = True
    s.gradient_merge_configs = {"k_steps": 3, "avg": True}
    model = LlamaForCausalLM(LlamaConfig.tiny(vocab=32, hidden=16, layers=2,
                                              heads=2, seq=8), device="cpu")
    inner = AdamW(learning_rate=1e-3, parameters=model.parameters())
    opt = fleet.Fleet().distributed_optimizer(inner, strategy=s)
    step = build_train_step(model, opt)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randint(0, 32, (4, 8)))
    for call in range(3):
        step(x, x)
        moved = any(not torch.equal(before[n], p)
                    for n, p in model.named_parameters())
        assert moved == (call == 2)
    assert inner._step_count == 3 and opt._step_count == 3


@pytest.mark.parametrize("toggle", TOGGLES)
def test_unimplemented_toggles_raise_as_the_reference(toggle):
    for s in (jfleet.DistributedStrategy(), fleet.DistributedStrategy()):
        assert getattr(s, toggle) is False
        setattr(s, toggle, False)
        with pytest.raises(NotImplementedError, match=toggle):
            setattr(s, toggle, True)


def test_strategy_fields_match_the_reference():
    want, got = jfleet.DistributedStrategy(), fleet.DistributedStrategy()
    for name in ("hybrid_configs", "amp_configs", "recompute_configs",
                 "sharding_configs", "pipeline_configs",
                 "tensor_parallel_configs", "gradient_merge_configs",
                 "gradient_scale_configs", "fuse_grad_size_in_MB"):
        assert getattr(got, name) == getattr(want, name), name
    assert repr(got) == repr(want)
