"""The port's datasets, samplers and DataLoader against the JAX package's,
on the CPU: sampler orders equal for the same numpy seed, batches equal
value for value."""
import numpy as np
import pytest
import torch

import torch_loader_data
from paddle_tpu import io as jio
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.models import build_train_step, prefetch_batches


def _data(n=10):
    rng = np.random.RandomState(0)
    return (rng.randint(0, 100, (n, 6)).astype(np.int64),
            rng.randn(n, 3).astype(np.float32))


@pytest.mark.parametrize("replacement", [False, True])
def test_random_sampler_order_matches_reference(replacement):
    ds = list(range(13))
    orders = []
    for mod in (jio, tio):
        np.random.seed(5)
        orders.append(list(mod.RandomSampler(ds, replacement=replacement,
                                             num_samples=9 if replacement
                                             else None)))
    assert orders[0] == orders[1]
    assert sorted(orders[1]) != orders[1]


def test_batch_and_distributed_samplers_match_reference():
    ds = list(range(11))
    np.random.seed(2)
    want = list(jio.BatchSampler(ds, shuffle=True, batch_size=3))
    np.random.seed(2)
    got = list(tio.BatchSampler(ds, shuffle=True, batch_size=3))
    assert got == want
    for rank in (0, 1, 2):
        kw = dict(batch_size=2, num_replicas=3, rank=rank, shuffle=True)
        w = jio.DistributedBatchSampler(ds, **kw)
        g = tio.DistributedBatchSampler(ds, **kw)
        w.set_epoch(4)
        g.set_epoch(4)
        assert list(g) == list(w) and len(g) == len(w)
    g = tio.DistributedBatchSampler(ds, batch_size=4)
    assert (g.nranks, g.local_rank) == (1, 0)


@pytest.mark.parametrize("num_workers", [0, 2])
@pytest.mark.parametrize("shuffle,drop_last", [(False, False),
                                               (True, True)])
def test_dataloader_batches_match_reference(num_workers, shuffle,
                                            drop_last):
    ids, feats = _data()
    batches = []
    for mod in (jio, tio):
        np.random.seed(7)
        loader = mod.DataLoader(mod.TensorDataset([ids, feats]),
                                batch_size=4, shuffle=shuffle,
                                drop_last=drop_last, num_workers=num_workers)
        batches.append([[np.asarray(getattr(t, "_data", t)) for t in b]
                        for b in loader])
        assert len(loader) == (2 if drop_last else 3)
    assert len(batches[0]) == len(batches[1])
    for bw, bg in zip(*batches):
        for w, g in zip(bw, bg):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_default_collate_stacks_structures():
    batch = tio.default_collate_fn([
        {"x": torch.ones(2), "n": 1, "s": "a"},
        {"x": torch.zeros(2), "n": 2, "s": "b"}])
    assert torch.equal(batch["x"], torch.tensor([[1.0, 1.0], [0.0, 0.0]]))
    assert batch["n"].tolist() == [1, 2] and batch["s"] == ["a", "b"]


def test_datasets_match_reference():
    ids, feats = _data(6)
    for mod in (jio, tio):
        cat = mod.ConcatDataset([mod.TensorDataset([ids[:2], feats[:2]]),
                                 mod.TensorDataset([ids[2:], feats[2:]])])
        assert len(cat) == 6
        np.testing.assert_array_equal(cat[4][0], ids[4])
        sub = mod.Subset(cat, [5, 0])
        np.testing.assert_array_equal(sub[0][1], feats[5])
        comp = mod.ComposeDataset([mod.TensorDataset([ids]),
                                   mod.TensorDataset([feats])])
        assert len(comp[1]) == 2
    parts = tio.random_split(list(range(10)), [0.3, 0.7])
    assert sorted(list(parts[0]) + list(parts[1])) == list(range(10))
    assert [len(p) for p in parts] == [3, 7]


def test_prefetch_on_the_cpu_returns_the_raw_iterator():
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.optimizer import SGD

    model = LlamaForCausalLM(LlamaConfig.tiny(vocab=32, hidden=32, layers=1,
                                              heads=2), device="cpu")
    step = build_train_step(model, SGD(parameters=model.parameters()))
    data = [(torch.zeros(1, 4), torch.ones(1, 4))] * 2
    it = prefetch_batches(step, data)
    assert not isinstance(it, tio.DevicePrefetcher)
    assert list(it) == data


@pytest.mark.parametrize("depth", [0, 2])
def test_device_prefetcher_stages_in_order_and_reraises(depth):
    pf = tio.DevicePrefetcher(iter(range(5)), lambda b: b * 10, depth=depth)
    assert list(pf) == [0, 10, 20, 30, 40]

    def bad():
        yield 1
        raise KeyError("boom")

    pf = tio.DevicePrefetcher(bad(), lambda b: b, depth=depth)
    assert next(pf) == 1
    with pytest.raises(KeyError):
        next(pf)
    pf.close()


@pytest.mark.parametrize("num_workers", [1, 2, 3])
def test_worker_processes_yield_the_reference_batches_in_order(num_workers):
    """`multiprocess=True` (forkserver workers over shared-memory rings)
    gives the reference's in-process batches, value for value and in
    sampler order (the reference's own worker transport is a slow test
    there, `tests/test_native.py:232`)."""
    ds = torch_loader_data.Pairs()
    np.random.seed(3)
    want = [[np.asarray(t._data) for t in b]
            for b in jio.DataLoader(ds, batch_size=5, shuffle=True)]
    np.random.seed(3)
    got = list(tio.DataLoader(ds, batch_size=5, shuffle=True,
                              num_workers=num_workers, multiprocess=True,
                              timeout=60))
    assert len(got) == len(want) == 8
    for (gx, gi), (wx, wi) in zip(got, want):
        assert isinstance(gx, torch.Tensor) and gx.dtype == torch.float32
        np.testing.assert_array_equal(gx.numpy(), wx)
        np.testing.assert_array_equal(gi.numpy(), wi)


def test_a_worker_error_reraises_in_the_trainer():
    dl = tio.DataLoader(torch_loader_data.Poison(), batch_size=2,
                        num_workers=2, multiprocess=True, timeout=60)
    with pytest.raises(RuntimeError, match="poison sample"):
        list(dl)


def test_a_worker_that_dies_raises_instead_of_hanging():
    dl = tio.DataLoader(torch_loader_data.Dies(), batch_size=2,
                        num_workers=2, multiprocess=True, timeout=60)
    with pytest.raises(RuntimeError, match="died"):
        list(dl)


def test_workers_know_themselves_and_take_every_nth_batch():
    """Batch i comes from worker i % num_workers (`get_worker_info`); a
    user collate_fn runs in the worker and its output is kept as it is;
    another start method ("spawn") is honoured."""
    got = list(tio.DataLoader(torch_loader_data.WhoReads(), batch_size=3,
                              num_workers=2, multiprocess=True,
                              timeout=60))
    assert [b["worker"].tolist() for b in got] == [[0] * 3, [1] * 3] * 2
    assert [b["i"].tolist() for b in got] == [[0, 1, 2], [3, 4, 5],
                                              [6, 7, 8], [9, 10, 11]]
    assert all(b["n"].tolist() == [2] * 3 for b in got)
    assert tio.get_worker_info() is None
    sums = list(tio.DataLoader(torch_loader_data.Pairs(), batch_size=10,
                               num_workers=2, multiprocess=True, timeout=60,
                               collate_fn=torch_loader_data.sum_collate,
                               mp_start_method="spawn"))
    assert sums == [45.0, 145.0, 245.0, 345.0]


def test_worker_batches_stage_through_the_device_prefetcher():
    loader = tio.DataLoader(torch_loader_data.Pairs(), batch_size=8,
                            num_workers=2, multiprocess=True, timeout=60)
    pf = tio.DevicePrefetcher(iter(loader), lambda b: b[1] * 2, depth=2)
    assert [t.tolist() for t in pf] == [[2 * i for i in range(s, s + 8)]
                                        for s in range(0, 40, 8)]


def test_read_ahead_thread_reraises_a_dataset_error():
    class Bad(tio.Dataset):
        def __len__(self):
            return 4

        def __getitem__(self, i):
            if i == 2:
                raise KeyError(i)
            return np.zeros(2)

    it = iter(tio.DataLoader(Bad(), batch_size=1, num_workers=1))
    assert next(it).shape == (1, 2)
    next(it)
    with pytest.raises(KeyError):
        next(it)
