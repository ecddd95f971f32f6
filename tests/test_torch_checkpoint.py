"""Distributed checkpoints in the port against the JAX package's, on the CPU.

The reference's `tests/test_checkpoint.py` scenarios (marked slow there;
this file is the tier-1 hold) run through both packages on the same
weights: a roundtrip, reshard on load (the reference's tp = 4 spec; the
port's template of `LocalPiece` blocks), the manager's async retention,
and model plus optimizer resume. The manager's protocol (its
`tests/test_faults.py` cases) through both: the same committed steps
after the same saves, a step without its COMMITTED marker skipped, a
corrupted leaf falling back to the last-known-good step
(`CheckpointIntegrityError` for an explicit step), retention keeping the
last-known-good step behind a torn tail. The reference's torn write is its
chaos fault (`checkpoint.torn_write`); the port's withholds the marker.

The distributed cases (gloo ranks, `torch_pp_workers.ckpt_pp_run`): a
pp 2 x sharding 2 ZeRO stage-2 (and stage-3) LLaMA saved after one step by
`fleet.save` and by `CheckpointManager.save`, resumed in fresh models,
optimizers and engines: the next step's loss and the parameters after it
bit-equal to the uninterrupted run's; the same checkpoint loaded at pp 1
in one process equal, bit for bit, to the ranks' state joined
(parameters, and the first moments from their ZeRO pieces). Beyond LLaMA
and GPT (`ckpt_generic`): a `PipelineLayer` at pp 2 and a model of
mp_layers at tp 2 saved by `fleet.save`, each rank's tensors under the
whole model's names, loaded back on the ranks and at pp 1 / tp 1 in one
process; a name that two ranks hold with different values, and a shard
without its place, refused.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.distributed.mesh as jmesh
from paddle_tpu import faults as jfaults
from paddle_tpu.distributed import checkpoint as jck
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import weights as W
from paddle_tpu_torch.distributed import checkpoint as tck
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.optimizer import Adam, AdamW
from torch_pp_workers import (LR, MP_SPLIT, TINY, generic_layer_values,
                              layer_descs, mp_net, mp_whole, pp_runs_main,
                              start_groups)


def _weights(seed):
    rng = np.random.RandomState(seed)
    return [(rng.randn(8, 16) * 0.3).astype(np.float32),
            (rng.randn(16) * 0.1).astype(np.float32),
            (rng.randn(16, 4) * 0.3).astype(np.float32),
            (rng.randn(4) * 0.1).astype(np.float32)]


def _jax_model(seed):
    m = paddle.nn.Sequential(paddle.nn.Linear(8, 16), paddle.nn.ReLU(),
                             paddle.nn.Linear(16, 4))
    for p, w in zip(m.parameters(), _weights(seed)):
        p.set_value(w)
    return m


class _Net(torch.nn.Module):
    """The reference's Sequential(Linear(8, 16), ReLU, Linear(16, 4)) with
    biases, under its parameter names."""

    def __init__(self, seed):
        super().__init__()
        w = _weights(seed)
        self.l0 = tnn.Linear(8, 16)
        self.l2 = tnn.Linear(16, 4)
        with torch.no_grad():
            self.l0.weight.copy_(torch.from_numpy(w[0]))
            self.l2.weight.copy_(torch.from_numpy(w[2]))
        self.b0 = torch.nn.Parameter(torch.from_numpy(w[1]))
        self.b2 = torch.nn.Parameter(torch.from_numpy(w[3]))

    def forward(self, x):
        return torch.relu(self.l0(x) + self.b0) @ self.l2.weight + self.b2

    def state(self):
        return {"0.weight": self.l0.weight, "0.bias": self.b0,
                "2.weight": self.l2.weight, "2.bias": self.b2}


def _jax_np(sd):
    return {k: np.asarray(v._data if hasattr(v, "_data") else v)
            for k, v in sd.items()}


def _port_np(sd):
    return {k: v.detach().numpy() if isinstance(v, torch.Tensor) else v
            for k, v in sd.items()}


def test_save_load_roundtrip(tmp_path):
    jm, tm = _jax_model(0), _Net(0)
    jck.save_state_dict(jm.state_dict(), str(tmp_path / "jax"))
    want = _jax_np(jck.load_state_dict(str(tmp_path / "jax"),
                                       template=jm.state_dict()))
    tck.save_state_dict(tm.state(), str(tmp_path / "port"))
    got = _port_np(tck.load_state_dict(str(tmp_path / "port"),
                                       template=tm.state()))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(got[k], _port_np(tm.state())[k])
    # template-less: the saved tree, every leaf whole
    assert set(tck.load_state_dict(str(tmp_path / "port"))) == set(want)


def test_reshard_on_load(tmp_path):
    """Saved replicated; loaded sharded over tp = 4 on the second dim of
    every 2-D weight: the reference by its spec over a mesh, the port by a
    template of each rank's `LocalPiece` block."""
    jm, tm = _jax_model(1), _Net(1)
    jck.save_state_dict(jm.state_dict(), str(tmp_path / "jax"))
    mesh = jmesh.build_mesh(tp=4, devices=np.asarray(jax.devices("cpu"))[:4])
    out = jck.load_state_dict(
        str(tmp_path / "jax"), template=jm.state_dict(), mesh=mesh,
        spec_fn=lambda n, a: (None, "tp") if len(a.shape) == 2 else None,
        return_tensors=False)
    assert "tp" in str(out["0.weight"].sharding.spec)
    whole = np.asarray(out["0.weight"])
    tck.save_state_dict(tm.state(), str(tmp_path / "port"))
    for r in range(4):
        template = {k: tck.LocalPiece(v, v.shape, [(0, v.shape[0]),
                                                   (r * v.shape[1] // 4,
                                                    v.shape[1] // 4)])
                    if v.dim() == 2 else v for k, v in tm.state().items()}
        got = tck.load_state_dict(str(tmp_path / "port"), template=template)
        piece = got["0.weight"]
        assert isinstance(piece, tck.LocalPiece)
        np.testing.assert_array_equal(
            piece.value.numpy(), whole[:, r * 4:(r + 1) * 4])
        np.testing.assert_array_equal(got["0.bias"].numpy(),
                                      np.asarray(out["0.bias"]))
    # a ZeRO-like flat piece of a block, read from a whole save
    template = {"0.weight": tck.LocalPiece(torch.zeros(5), (8, 16),
                                           [(2, 4), (0, 16)], (7, 12))}
    got = tck.load_state_dict(str(tmp_path / "port"), template=template)
    np.testing.assert_array_equal(got["0.weight"].value.numpy(),
                                  whole[2:6].reshape(-1)[7:12])


def _retention_run(ck, model, state, set_value, directory):
    with ck.CheckpointManager(directory, max_to_keep=2) as mgr:
        for step in (0, 1, 2, 3):
            set_value(step)
            assert mgr.save(step, state())
        mgr.wait()
        out = mgr.restore(template=state())
        return (mgr.latest_step(), mgr.all_steps(), mgr.committed_steps(),
                float(np.asarray(out["0.bias"])[0]))


def test_manager_async_retention(tmp_path):
    jm, tm = _jax_model(2), _Net(2)

    def jset(step):
        jm.state_dict()["0.bias"].set_value(
            np.full((16,), float(step), np.float32))

    def tset(step):
        with torch.no_grad():
            tm.b0.fill_(float(step))

    want = _retention_run(jck, jm, jm.state_dict, jset,
                          str(tmp_path / "jax"))
    got = _retention_run(tck, tm, tm.state, tset, str(tmp_path / "port"))
    assert want == (3, [2, 3], [2, 3], 3.0)
    assert got == want


def _train(step_fn, n):
    for _ in range(n):
        step_fn()


def test_model_optimizer_resume(tmp_path):
    x = np.random.RandomState(0).randn(4, 8).astype(np.float32)
    # the reference
    jm = _jax_model(3)
    jopt = paddle.optimizer.Adam(learning_rate=1e-3,
                                 parameters=jm.parameters())
    jx = paddle.to_tensor(x)

    def jstep(m, o):
        (m(jx) ** 2).mean().backward()
        o.step()
        o.clear_grad()

    _train(lambda: jstep(jm, jopt), 3)
    jck.save_model_state(jm, jopt, str(tmp_path / "jax"))
    jm2 = _jax_model(9)
    jopt2 = paddle.optimizer.Adam(learning_rate=1e-3,
                                  parameters=jm2.parameters())
    jck.load_model_state(jm2, jopt2, str(tmp_path / "jax"))
    jstep(jm2, jopt2)
    # the port
    tm = _Net(3)
    topt = Adam(learning_rate=1e-3, parameters=tm.parameters())
    tx = torch.from_numpy(x)

    def tstep(m, o):
        (m(tx) ** 2).mean().backward()
        o.step()
        o.clear_grad()

    _train(lambda: tstep(tm, topt), 3)
    tck.save_model_state(tm, topt, str(tmp_path / "port"))
    tm2 = _Net(9)
    topt2 = Adam(learning_rate=1e-3, parameters=tm2.parameters())
    tck.load_model_state(tm2, topt2, str(tmp_path / "port"))
    for k, v in _port_np(tm.state()).items():
        np.testing.assert_array_equal(_port_np(tm2.state())[k], v)
    tstep(tm, topt)
    tstep(tm2, topt2)
    want = {k: np.asarray(v._data) for k, v in jm2.state_dict().items()}
    for k, v in _port_np(tm.state()).items():
        # resumed equals uninterrupted, bit for bit; both the reference's
        np.testing.assert_array_equal(_port_np(tm2.state())[k], v)
        np.testing.assert_allclose(v, want[k], rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the manifest protocol, through both packages


def _state(step):
    return {"w": np.full((4,), float(step), dtype=np.float32),
            "b": np.arange(3, dtype=np.int32) + step}


@pytest.fixture
def torn():
    """torn(package, steps): the saves of these steps never commit (the
    reference's chaos `checkpoint.torn_write`; the port's marker
    withheld)."""
    prev = paddle.get_flags(["FLAGS_chaos"])
    plain = tck.CheckpointManager._commit

    def arm(pkg, steps):
        if pkg is jck:
            paddle.set_flags({"FLAGS_chaos": ";".join(
                f"checkpoint.torn_write@step={s}" for s in steps)})
            jfaults.reset()
        else:
            tck.CheckpointManager._commit = lambda self, step: None if \
                step in steps else plain(self, step)

    yield arm
    paddle.set_flags(prev)
    jfaults.reset()
    tck.CheckpointManager._commit = plain


def _w(out):
    return np.asarray(out["w"]).tolist()


@pytest.mark.parametrize("pkg", [jck, tck], ids=["reference", "port"])
def test_committed_steps_and_their_checksums(tmp_path, pkg):
    with pkg.CheckpointManager(tmp_path / "ckpt", max_to_keep=5,
                               async_save=False) as cm:
        for s in (1, 2, 3):
            assert cm.save(s, _state(s), force=True)
        cm.wait()
        assert cm.committed_steps() == [1, 2, 3]
        assert cm.last_known_good() == 3
        sums = cm.manifest(3)["checksums"]
    assert sums == jck._leaf_checksums(_state(3))
    assert sums == tck._leaf_checksums(_state(3))


@pytest.mark.parametrize("pkg", [jck, tck], ids=["reference", "port"])
def test_uncommitted_step_is_skipped(tmp_path, pkg, torn):
    torn(pkg, {3})
    with pkg.CheckpointManager(tmp_path / "ckpt", max_to_keep=5,
                               async_save=False) as cm:
        for s in (1, 2, 3):
            assert cm.save(s, _state(s), force=True)
        cm.wait()
        assert not cm.is_committed(3)
        assert _w(cm.restore(return_tensors=False)) == [2.0] * 4
        assert cm.last_known_good() == 2


@pytest.mark.parametrize("pkg", [jck, tck], ids=["reference", "port"])
def test_corrupt_leaf_falls_back_to_the_last_known_good(tmp_path, pkg):
    with pkg.CheckpointManager(tmp_path / "ckpt", max_to_keep=5,
                               async_save=False) as cm:
        for s in (1, 2, 3):
            assert cm.save(s, _state(s), force=True)
        cm.wait()
        path = cm._manifest_path(3)
        with open(path) as f:
            m = json.load(f)
        m["checksums"]["w"]["crc"] ^= 1
        with open(path, "w") as f:
            json.dump(m, f)
        assert _w(cm.restore(return_tensors=False)) == [2.0] * 4
        with pytest.raises(pkg.CheckpointIntegrityError):
            cm.restore(step=3, return_tensors=False)


def test_corrupt_bytes_in_a_port_file_fall_back(tmp_path):
    """The port checks every piece it reads against the manifest: a byte
    flipped in step 3's data file falls back to step 2."""
    with tck.CheckpointManager(tmp_path / "ckpt", async_save=False) as cm:
        for s in (1, 2, 3):
            assert cm.save(s, _state(s), force=True)
        cm.wait()
        data = tmp_path / "ckpt" / "3" / "rank0.pt"
        raw = bytearray(data.read_bytes())
        at = raw.find(np.full((4,), 3.0, np.float32).tobytes())
        assert at > 0
        raw[at] ^= 0xFF
        data.write_bytes(bytes(raw))
        assert _w(cm.restore(return_tensors=False)) == [2.0] * 4
        assert cm.counts["restore_fallbacks"] == 1
        with pytest.raises(tck.CheckpointIntegrityError):
            cm.restore(step=3)


@pytest.mark.parametrize("pkg", [jck, tck], ids=["reference", "port"])
def test_retention_keeps_the_last_known_good(tmp_path, pkg, torn):
    torn(pkg, {2, 3, 4})
    with pkg.CheckpointManager(tmp_path / "ckpt", max_to_keep=2,
                               async_save=False) as cm:
        for s in (1, 2, 3, 4):
            assert cm.save(s, _state(s), force=True)
        cm.wait()
        cm._prune()
        assert 1 in cm.all_steps()
        assert cm.last_known_good() == 1
        assert _w(cm.restore(return_tensors=False)) == [1.0] * 4


def test_should_save_and_trainer_state_roundtrip(tmp_path):
    """`should_save` on the interval after the latest step, as the
    reference's; the trainer snapshot is JSON and restores the port's
    stream exactly."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.framework import random as trandom

    seen = []
    for cm in (jck.CheckpointManager(str(tmp_path / "jax"),
                                     save_interval_steps=2),
               tck.CheckpointManager(tmp_path / "port",
                                     save_interval_steps=2)):
        before = [cm.should_save(s) for s in range(8)]
        assert cm.save(2, _state(2))
        cm.wait()
        saved = [cm.save(s, _state(s)) for s in (3, 5, 6)]
        cm.wait()
        seen.append((before, saved, cm.all_steps()))
        cm.close()
    assert seen[0] == ([True] * 8, [False, False, True], [2, 6])
    assert seen[1] == seen[0]
    ptt.seed(123)
    trandom.next_seed()
    snap = tck.trainer_state_snapshot(step=5, data_position=7)
    json.dumps(snap)
    want = [trandom.next_seed() for _ in range(4)]
    ptt.seed(999)
    back = tck.apply_trainer_state(snap)
    assert back["step"] == 5 and back["data_position"] == 7
    assert [trandom.next_seed() for _ in range(4)] == want


# ---------------------------------------------------------------------------
# pp 2 x sharding 2 under ZeRO, on four gloo ranks


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """{stage: (checkpoint directory, [rank results])}, and "generic":
    the same of `ckpt_generic`."""
    rng = np.random.RandomState(5)
    x, y = rng.randint(0, 64, (8, 16)), rng.randint(0, 64, (8, 16))
    state = W.llama_state_to_numpy(LlamaForCausalLM(
        LlamaConfig.tiny(layers=4, **TINY), device="cpu", seed=4))
    state = {k: v.copy() for k, v in state.items()}
    dirs = {s: str(tmp_path_factory.mktemp(f"zero{s}")) for s in (2, 3)}
    dirs["generic"] = str(tmp_path_factory.mktemp("generic"))
    gx = rng.normal(size=(4, 8)).astype(np.float32)
    gy = rng.randint(0, 8, 4)
    join = start_groups(pp_runs_main, {4: [
        (f"s{s}", "ckpt_pp", dict(state=state, x=x, y=y, ckpt_dir=dirs[s],
                                  stage=s)) for s in (2, 3)] + [
        ("generic", "ckpt_generic", dict(ckpt_dir=dirs["generic"], x=gx,
                                         y=gy))]})
    ranks = join()[4]
    out = {s: (dirs[s], [r[f"s{s}"] for r in ranks]) for s in (2, 3)}
    out["generic"] = (dirs["generic"], [r["generic"] for r in ranks])
    return out


@pytest.mark.parametrize("stage", [2, 3])
def test_a_resumed_run_is_the_uninterrupted_run(saved, stage):
    _, res = saved[stage]
    for r in res:
        assert r["resumed"] == r["full"] and r["loaded"] == r["full"]
        for k, v in r["full_state"].items():
            if not k.startswith("@"):
                np.testing.assert_array_equal(r["resumed_state"][k], v)
                np.testing.assert_array_equal(r["loaded_state"][k], v)
        assert r["trainer_step"] == 1 and r["spec_rows"]
        assert r["counts"]["saves"] == 1 and \
            r["counts"]["restore_fallbacks"] == 0
    assert len({tuple(r["full"]) for r in res}) == 1


def _joined_moments(res, shapes):
    """{name: the whole first moment} from every rank's ZeRO pieces."""
    out = {}
    for r in res:
        for n, (lo, hi, m) in r["moments1"].items():
            flat = out.setdefault(n, np.full(int(np.prod(shapes[n])),
                                             np.nan, np.float32))
            flat[lo:hi] = m
    return {n: f.reshape(shapes[n]) for n, f in out.items()}


@pytest.mark.parametrize("stage", [2, 3])
def test_a_sharded_state_loads_at_pp1_bit_for_bit(saved, stage):
    """The pp 2 x sharding 2 checkpoint read by one process at pp 1 (no
    mesh, a plain AdamW): every parameter and first moment equal to the
    ranks' state joined; the step count carried."""
    path, res = saved[stage]
    cfg = LlamaConfig.tiny(layers=4, **TINY)
    model = LlamaForCausalLM(cfg, device="cpu", seed=99)
    opt = AdamW(learning_rate=LR, parameters=model.parameters())
    tck.load_model_state(model, opt, os.path.join(path, "fleet"))
    want = W.gather_llama_state([r["after1"] for r in res], cfg)
    got = W.llama_state_to_numpy(model)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v)
    moments = _joined_moments(res, W.llama_param_shapes(cfg))
    names = {id(p): n for n, p in model.named_parameters()}
    for i, st in opt._accumulators.items():
        n = names[id(opt._parameter_list[i])]
        np.testing.assert_array_equal(st["moment1"].numpy(), moments[n])
    assert opt._step_count == 1


# ---------------------------------------------------------------------------
# beyond LLaMA and GPT: a PipelineLayer at pp 2, mp_layers at tp 2


def test_a_pipeline_layer_saves_every_stage(saved):
    """Each stage's entries under their desc's index (the shared linear
    under each desc that uses it), read back on the ranks with the
    optimizer, and at pp 1 by one process: every entry the stage that
    holds it saved, none dropped."""
    import torch.nn.functional as TF

    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        LayerDesc, PipelineLayer, SharedLayerDesc)

    path, res = saved["generic"]
    for r in res:
        assert r["layer_loaded"] and r["layer_moments"]
    names = [set(r["layer_held"]) for r in res]
    by_stage = {r["stage"]: set(r["layer_held"]) for r in res}
    assert by_stage[0] == {"_layer_list.0.weight", "_layer_list.2.weight"}
    assert by_stage[1] == {"_layer_list.4.weight", "_layer_list.6.weight"}
    assert names.count(by_stage[0]) == names.count(by_stage[1]) == 2
    whole = PipelineLayer(layer_descs(LayerDesc, SharedLayerDesc, tnn.Linear),
                          num_stages=2, loss_fn=TF.cross_entropy)
    tck.load_model_state(whole, None, os.path.join(path, "layer"))
    held = {n: v for r in res for n, v in r["layer_held"].items()}
    got = W.param_pieces(whole)
    assert set(got) == set(held)
    for n, (v, *_) in got.items():
        np.testing.assert_array_equal(v.numpy(), held[n])
    # the shared linear: one weight, the same on both stages
    np.testing.assert_array_equal(held["_layer_list.0.weight"],
                                  held["_layer_list.6.weight"])
    # the step moved what it trained
    first = generic_layer_values(whole)
    assert not np.array_equal(held["_layer_list.4.weight"],
                              first["_layer_list.4.weight"])


def test_a_tensor_parallel_model_saves_its_shards_in_place(saved):
    """mp_layers' shards (`split_axis`, `tp_shard`) saved as blocks of the
    whole tensors: read back on the ranks, and at tp 1 by one process equal
    to the whole tensors the ranks held slices of."""
    path, res = saved["generic"]
    assert all(r["mp_loaded"] for r in res)
    net = mp_net()
    tck.load_model_state(net, None, os.path.join(path, "mp"))
    whole = mp_whole()
    assert set(dict(net.named_parameters())) == set(MP_SPLIT)
    for n, p in net.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), whole[n])


def test_one_name_for_two_tensors_is_refused(saved):
    """A name that two ranks hold with different values, and a shard
    without its place in the whole tensor, raise on every rank (nothing
    written for one copy alone)."""
    _, res = saved["generic"]
    for r in res:
        differ, unplaced = r["refusals"]
        assert differ and "one name for two tensors" in differ
        assert unplaced and "split_axis" in unplaced
