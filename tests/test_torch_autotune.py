"""The port's flags registry and measured dispatch
(`paddle_tpu_torch/framework/config.py`, `paddle_tpu_torch/kernels/autotune.py`)
against the JAX package's contract, on the CPU.

Everything that measures runs with an injected fake timer, as
`tests/test_autotune.py` does for the reference, so no test here depends on
a clock or a card. Routing goes through the plain versions (CPU tensors):
the tests check which implementation the dispatch chose, and that its
result equals the plain one (f32, 1e-5 absolute; the same arithmetic).
"""
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu_torch
from paddle_tpu.framework import config as jconfig
from paddle_tpu.kernels import autotune as jat
from paddle_tpu_torch.framework import config as tconfig
from paddle_tpu_torch.kernels import autotune as at
from paddle_tpu_torch.kernels import matmul as kmm
from paddle_tpu_torch.kernels import paged_attention as kpa
from paddle_tpu_torch.nn import functional as F

ROOT = Path(__file__).resolve().parents[1]
_NAMES = ("FLAGS_autotune", "FLAGS_autotune_cache_dir",
          "FLAGS_paged_grouped_kernel")


@pytest.fixture
def tuner_env(tmp_path):
    """Tuner on, its table in a temporary directory; flags, timer and tuner
    restored afterwards."""
    old = tconfig.get_flags(list(_NAMES))
    tconfig.set_flags({"FLAGS_autotune": "on",
                       "FLAGS_autotune_cache_dir": str(tmp_path)})
    at.reset_tuner()
    yield tmp_path
    tconfig.set_flags(old)
    at.set_timer(None)
    at.reset_tuner()


# ---------------------------------------------------------------------------
# the flags registry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", _NAMES)
def test_flag_defaults_equal_the_reference(name):
    assert tconfig._FLAGS[name].default == jconfig._FLAGS[name].default
    assert tconfig._FLAGS[name].type is jconfig._FLAGS[name].type


def test_flags_are_seeded_from_the_environment(monkeypatch):
    monkeypatch.setenv("FLAGS_paged_grouped_kernel", "yes")
    monkeypatch.setenv("FLAGS_autotune", "readonly")
    assert tconfig._Flag("FLAGS_paged_grouped_kernel", False, bool,
                         "").value is True
    assert tconfig._Flag("FLAGS_autotune", "off", str, "").value == \
        "readonly"
    monkeypatch.setenv("FLAGS_paged_grouped_kernel", "0")
    assert tconfig._Flag("FLAGS_paged_grouped_kernel", False, bool,
                         "").value is False


def test_flags_seeded_at_import_in_a_fresh_process():
    env = dict(os.environ, PYTHONPATH=str(ROOT), FLAGS_autotune="on",
               FLAGS_paged_grouped_kernel="true",
               FLAGS_autotune_cache_dir="/nonexistent/dir")
    code = ("import json, paddle_tpu_torch as p\n"
            f"print(json.dumps(p.get_flags({list(_NAMES)!r})))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout) == {
        "FLAGS_autotune": "on", "FLAGS_autotune_cache_dir": "/nonexistent/dir",
        "FLAGS_paged_grouped_kernel": True}


def test_set_flags_parses_strings_and_get_flags_reads_back():
    old = tconfig.get_flags(list(_NAMES))
    try:
        paddle_tpu_torch.set_flags({"FLAGS_paged_grouped_kernel": "on",
                                    "FLAGS_autotune": "readonly"})
        assert paddle_tpu_torch.get_flags(
            ["FLAGS_paged_grouped_kernel", "FLAGS_autotune", "FLAGS_nope"]) \
            == {"FLAGS_paged_grouped_kernel": True,
                "FLAGS_autotune": "readonly"}
        paddle_tpu_torch.set_flags({"FLAGS_paged_grouped_kernel": False})
        assert tconfig.get_flag("FLAGS_paged_grouped_kernel") is False
        assert at.mode() == "readonly" and at.enabled()
        paddle_tpu_torch.set_flags({"FLAGS_autotune": "bogus"})
        assert at.mode() == "off"  # an unknown mode is off
    finally:
        tconfig.set_flags(old)
    assert paddle_tpu_torch.set_flags is tconfig.set_flags
    assert paddle_tpu_torch.get_flags is tconfig.get_flags


# ---------------------------------------------------------------------------
# the tuner's contract, with a fake timer
# ---------------------------------------------------------------------------


def _timed_candidates(table):
    """Candidates whose functions name themselves to the fake timer."""
    cands = []
    for name, (kind, _t) in table.items():
        def fn(*a):
            return None

        fn.__autotune_name__ = name
        cands.append(at.Candidate(name, kind, fn, {"name": name}))
    return cands


def _timer_for(table, calls=None):
    def timer(fn, args):
        if calls is not None:
            calls.append(fn.__autotune_name__)
        return table[fn.__autotune_name__][1]

    return timer


BUCKET = (("m", 256), ("dt", "float32"))


def test_miss_measures_then_hits(tuner_env):
    table = {"torch": ("library", 2.0), "cuda:m16": ("kernel", 1.0)}
    calls = []
    at.set_timer(_timer_for(table, calls))
    t = at.get_tuner()
    cands = _timed_candidates(table)
    assert t.pick("matmul", BUCKET, cands, lambda: (None,)).name == \
        "cuda:m16"
    assert sorted(calls) == ["cuda:m16", "torch"]
    calls.clear()
    assert t.pick("matmul", BUCKET, cands, lambda: (None,)).name == \
        "cuda:m16"
    assert calls == []


def test_persistence_round_trip(tuner_env):
    table = {"torch": ("library", 1.0), "cuda:m64": ("kernel", 3.0)}
    at.set_timer(_timer_for(table))
    t = at.Autotuner(cache_dir=str(tuner_env), device="fake")
    cands = _timed_candidates(table)
    t.pick("matmul", BUCKET, cands, lambda: (None,))
    path = t.cache_path()
    assert os.path.basename(path) == "autotune_fake.json"
    payload = json.load(open(path))
    assert payload["schema_version"] == at.SCHEMA_VERSION
    assert payload["device_kind"] == "fake"
    (key, entry), = payload["entries"].items()
    assert entry == {"winner": "torch", "op": "matmul",
                     "timings_ms": {"torch": 1.0, "cuda:m64": 3.0}}
    calls = []
    at.set_timer(_timer_for(table, calls))
    t2 = at.Autotuner(cache_dir=str(tuner_env), device="fake")
    assert t2.pick("matmul", BUCKET, cands, lambda: (None,)).name == "torch"
    assert calls == []


def test_readonly_never_times(tuner_env):
    tconfig.set_flags({"FLAGS_autotune": "readonly"})
    calls = []
    table = {"torch": ("library", 1.0)}
    at.set_timer(_timer_for(table, calls))
    t = at.Autotuner(cache_dir=str(tuner_env), device="fake")
    assert t.pick("matmul", BUCKET, _timed_candidates(table),
                  lambda: (None,)) is None
    assert calls == []


def test_off_mode_skips_everything(tuner_env):
    tconfig.set_flags({"FLAGS_autotune": "off"})
    at.set_timer(lambda fn, args: pytest.fail("timed with the tuner off"))
    t = at.Autotuner(cache_dir=str(tuner_env), device="fake")
    assert t.pick("matmul", BUCKET,
                  _timed_candidates({"torch": ("library", 1.0)}),
                  lambda: (None,)) is None
    assert at.choose_matmul(8, 128, 128, torch.float32) is None


def test_kernel_version_tag_in_key_is_the_ports_own():
    key = at.Autotuner.make_key("matmul", BUCKET)
    assert key.split("|")[:2] == ["matmul", at.KERNEL_VERSIONS["matmul"]]
    for op, tag in at.KERNEL_VERSIONS.items():
        assert tag != jat.KERNEL_VERSIONS[op]
        assert at.Autotuner.make_key(op, BUCKET) != \
            jat.Autotuner.make_key(op, BUCKET)


def test_default_table_lives_in_the_ports_cache_dir(monkeypatch, tmp_path):
    old = tconfig.get_flags(["FLAGS_autotune_cache_dir"])
    monkeypatch.setenv("HOME", str(tmp_path))
    try:
        tconfig.set_flags({"FLAGS_autotune_cache_dir": ""})
        path = at.Autotuner().cache_path()
    finally:
        tconfig.set_flags(old)
    assert path == os.path.join(str(tmp_path), ".cache", "paddle_tpu_torch",
                                f"autotune_{at.device_kind()}.json")
    assert at.device_kind() == "cpu"  # no card here


def test_ineligible_winner_falls_to_fastest_eligible(tuner_env):
    table = {"torch": ("library", 3.0), "cuda:m128": ("kernel", 1.0),
             "cuda:m64": ("kernel", 2.0)}
    at.set_timer(_timer_for(table))
    t = at.Autotuner(cache_dir=str(tuner_env), device="fake")
    win = t.pick("matmul", BUCKET, _timed_candidates(table),
                 lambda: (None,), eligible=lambda c: c.name != "cuda:m128")
    assert win.name == "cuda:m64"


def test_corrupt_table_reads_as_empty(tuner_env):
    t = at.Autotuner(cache_dir=str(tuner_env), device="fake")
    with open(t.cache_path(), "w") as f:
        f.write("{not json")
    table = {"torch": ("library", 1.0)}
    at.set_timer(_timer_for(table))
    assert t.pick("matmul", BUCKET, _timed_candidates(table),
                  lambda: (None,)).name == "torch"
    assert json.load(open(t.cache_path()))["entries"]  # rewritten whole


def test_random_timings_never_pick_a_slower_kernel(tuner_env):
    rng = np.random.RandomState(0)
    for trial in range(50):
        table = {"torch": ("library", float(rng.uniform(0.1, 10)))}
        for i in range(4):
            table[f"cuda:{i}"] = ("kernel", float(rng.uniform(0.1, 10)))
        at.set_timer(_timer_for(table))
        t = at.Autotuner(cache_dir=str(tuner_env), device="fake")
        win = t.pick("matmul", (("trial", trial),) + BUCKET,
                     _timed_candidates(table), lambda: (None,))
        assert table[win.name][1] == min(v for _, v in table.values())
        if win.kind == "kernel":
            assert table[win.name][1] <= table["torch"][1]


def test_ties_go_to_torch_matmul(tuner_env):
    table = {"cuda:m16": ("kernel", 1.0), "torch": ("library", 1.0),
             "cuda:m64": ("kernel", 1.0)}
    at.set_timer(_timer_for(table))
    t = at.Autotuner(cache_dir=str(tuner_env), device="fake")
    assert t.pick("matmul", BUCKET, _timed_candidates(table),
                  lambda: (None,)).name == "torch"


def test_a_candidate_that_raises_makes_pick_raise(tuner_env):
    def timer(fn, args):
        if fn.__autotune_name__ == "cuda:m16":
            raise RuntimeError("kernel launch failed")
        return 1.0

    at.set_timer(timer)
    t = at.Autotuner(cache_dir=str(tuner_env), device="fake")
    table = {"torch": ("library", 1.0), "cuda:m16": ("kernel", 0.5)}
    with pytest.raises(RuntimeError, match="launch failed"):
        t.pick("matmul", BUCKET, _timed_candidates(table), lambda: (None,))
    assert t.snapshot() == {}  # nothing recorded


def test_no_measurement_without_a_card_or_a_custom_timer(tuner_env):
    assert not torch.cuda.is_available()
    assert not at.measurement_allowed()
    assert at.choose_matmul(8, 128, 128, torch.float32) is None
    tconfig.set_flags({"FLAGS_autotune": "readonly"})
    assert at.measurement_allowed()  # readonly never measures anyway


# ---------------------------------------------------------------------------
# routing: choose_matmul and choose_paged_decode
# ---------------------------------------------------------------------------


def _by_name(times, default):
    return lambda fn, args: times.get(getattr(fn, "__name__", ""), default)


def test_linear_routes_to_the_kernel_tile_that_won(tuner_env, monkeypatch):
    # torch.matmul 5 ms; the kernel tiles 2 ms, but the m64 tile 1 ms
    def timer(fn, args):
        if fn is torch.matmul:
            return 5.0
        return 1.0 if fn.__defaults__ == (64,) else 2.0

    at.set_timer(timer)
    seen = []
    real = kmm.matmul_fused
    monkeypatch.setattr(kmm, "matmul_fused",
                        lambda x, w, tile=None: seen.append(tile)
                        or real(x, w, tile))
    rng = np.random.RandomState(6)
    x = torch.from_numpy(rng.randn(2, 32, 256).astype(np.float32))
    w = torch.from_numpy(rng.randn(256, 128).astype(np.float32))
    y = F.linear(x, w)
    assert seen == [64]
    torch.testing.assert_close(y, torch.matmul(x, w), rtol=0, atol=1e-5)
    entry = at.get_tuner().lookup(at.Autotuner.make_key(
        "matmul", (("m", 64), ("k", 256), ("n", 128), ("dt", "float32"))))
    assert entry["winner"] == "cuda:m64"
    assert set(entry["timings_ms"]) == {"torch", "cuda:m16", "cuda:m64"}


def test_linear_keeps_torch_matmul_when_it_wins(tuner_env, monkeypatch):
    at.set_timer(lambda fn, args: 1.0 if fn is torch.matmul else 5.0)
    monkeypatch.setattr(kmm, "matmul_fused", lambda *a, **k: pytest.fail(
        "the kernel ran though torch.matmul won"))
    x = torch.randn(64, 256)
    w = torch.randn(256, 128)
    assert torch.equal(F.linear(x, w), torch.matmul(x, w))


def test_linear_skips_the_tuner_for_shapes_the_kernel_does_not_take(
        tuner_env):
    at.set_timer(lambda fn, args: pytest.fail("timed an unsupported shape"))
    x = torch.randn(4, 100)
    w = torch.randn(100, 128)  # k % 64 != 0
    assert torch.equal(F.linear(x, w), torch.matmul(x, w))
    x = torch.randn(4, 128, dtype=torch.float16)
    w = torch.randn(128, 128, dtype=torch.float16)  # no f16 kernel
    assert torch.equal(F.linear(x, w), torch.matmul(x, w))


def test_choose_matmul_is_one_memo_lookup_on_a_hit(tuner_env):
    calls = []
    at.set_timer(lambda fn, args: calls.append(fn) or 1.0)
    first = at.choose_matmul(8, 128, 128, torch.float32)
    assert len(calls) == 3  # torch and the two f32 tiles
    for _ in range(5):
        assert at.choose_matmul(8, 128, 128, torch.float32) is first
    assert len(calls) == 3
    assert first.name == "torch"  # all equal: the tie goes to torch


def _decode_args(seed=1, b=2, q_heads=4, kv_heads=2, pps=8, lens=(100, 7),
                 dtype=torch.float32):
    rng = np.random.RandomState(seed)
    n_pages = b * pps
    shape = (kv_heads, n_pages, 16, 128)
    kp = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dtype)
    vp = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dtype)
    q = torch.from_numpy(rng.randn(b, q_heads, 128).astype(np.float32)) \
        .to(dtype)
    tables = torch.from_numpy(rng.permutation(n_pages).reshape(b, pps)
                              .astype(np.int32))
    return q, kp, vp, tables, torch.tensor(lens, dtype=torch.int32)


def _spy(monkeypatch, seen):
    for name in ("paged_attention", "paged_attention_grouped"):
        real = getattr(kpa, name)

        @functools.wraps(real)
        def spy(*a, _real=real, _name=name, **kw):
            seen.append(_name)
            return _real(*a, **kw)

        monkeypatch.setattr(kpa, name, spy)


def test_paged_decode_tuned_winner_routes(tuner_env, monkeypatch):
    tconfig.set_flags({"FLAGS_paged_grouped_kernel": True})
    at.set_timer(_by_name({"paged_attention_grouped": 1.0}, 10.0))
    seen = []
    _spy(monkeypatch, seen)
    args = _decode_args()
    out = kpa.paged_attention_dispatch(*args)
    assert seen == ["paged_attention_grouped"]
    torch.testing.assert_close(out, kpa.paged_attention_ref(*args), rtol=0,
                               atol=1e-5)
    entry = at.get_tuner().lookup(at.Autotuner.make_key(
        "paged_decode", (("b", 2), ("qh", 4), ("kvh", 2), ("d", 128),
                         ("page", 16), ("pps", 8), ("dt", "float32"),
                         ("quant", 0))))
    assert entry["winner"] == "grouped"
    assert set(entry["timings_ms"]) == {"paged", "grouped"}


def test_paged_decode_tuner_beats_the_grouped_flag(tuner_env, monkeypatch):
    """The tuner's winner comes first: with the flag on and the per-page
    kernel faster, the per-page kernel runs."""
    tconfig.set_flags({"FLAGS_paged_grouped_kernel": True})
    at.set_timer(_by_name({"paged": 1.0}, 10.0))
    seen = []
    _spy(monkeypatch, seen)
    kpa.paged_attention_dispatch(*_decode_args())
    assert seen == ["paged_attention"]


def test_grouped_is_no_candidate_without_its_flag(tuner_env):
    tconfig.set_flags({"FLAGS_paged_grouped_kernel": False})
    at.set_timer(lambda fn, args: 1.0)
    win = at.choose_paged_decode(2, 4, 2, 128, 16, 8, torch.float32, False)
    assert win.name == "paged"
    (entry,) = at.get_tuner().snapshot().values()
    assert set(entry["timings_ms"]) == {"paged"}


def test_int8_pages_have_only_the_int8_kernel(tuner_env):
    tconfig.set_flags({"FLAGS_paged_grouped_kernel": True})
    at.set_timer(lambda fn, args: 1.0)
    win = at.choose_paged_decode(2, 4, 2, 128, 16, 8, torch.float32, True)
    assert win.meta == {"impl": "paged"}
    (entry,) = at.get_tuner().snapshot().values()
    assert set(entry["timings_ms"]) == {"paged"}


def test_decode_candidates_are_only_kernels_that_take_the_shape(tuner_env):
    """A multi-query group (32 query heads on one KV head) has both
    kernels as candidates; a head_dim no decode kernel takes has none,
    and the tuner times nothing."""
    tconfig.set_flags({"FLAGS_paged_grouped_kernel": True})
    at.set_timer(lambda fn, args: 1.0)
    win = at.choose_paged_decode(2, 32, 1, 128, 16, 8, torch.float32, False)
    assert win is not None
    (entry,) = at.get_tuner().snapshot().values()
    assert set(entry["timings_ms"]) == {"paged", "grouped"}
    assert kpa.supports(256) and not kpa.supports(96)
    assert at.choose_paged_decode(2, 4, 2, 96, 16, 8, torch.float32,
                                  False) is None
    assert len(at.get_tuner().snapshot()) == 1


def test_grouped_winner_not_taken_where_the_width_does_not_fit(tuner_env):
    """The bucket rounds 12 pages up to 16 (a multiple of 8), where the
    grouped kernel won; the concrete table of 12 pages takes the fastest
    eligible candidate, the per-page kernel."""
    tconfig.set_flags({"FLAGS_paged_grouped_kernel": True})
    at.set_timer(_by_name({"paged_attention_grouped": 1.0}, 10.0))
    win = at.choose_paged_decode(2, 4, 2, 128, 16, 12, torch.float32, False)
    assert win.name == "paged"
    (entry,) = at.get_tuner().snapshot().values()
    assert entry["winner"] == "grouped"
