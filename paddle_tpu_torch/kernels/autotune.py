"""Shape-bucketed measured dispatch (counterpart of
`paddle_tpu/kernels/autotune.py`).

At the first call of a shape bucket, (op, bucket, dtype) on a card, the
tuner times every candidate implementation on example inputs of the
bucket's shape and keeps the winner, with every candidate's time, in a
table on disk, so later calls and later processes reuse the measurement.

Contract:
  * `FLAGS_autotune` is one of off, on, readonly. `off` (the default): the
    call sites take their fixed dispatch, bit for bit what they ran
    before the tuner existed. `on`: a bucket missing from the table is
    measured and saved. `readonly`: the table's winners are used, and a
    miss never times anything (the call site takes its fixed dispatch).
  * The winner is the measured argmin, so a kernel that timed slower than
    the library baseline (`torch.matmul`) is never picked; on equal times
    the baseline wins.
  * A candidate that fails while it is measured raises: a broken kernel
    is never hidden by dropping out of the table.
  * The timer is injectable (`set_timer`) and the directory of the table
    can be set (`FLAGS_autotune_cache_dir`), so the tests depend neither
    on a card nor on $HOME.

On a CUDA card the candidates are the port's hand-written kernels and,
for the dense matmul only, `torch.matmul` (the JAX package's baseline is
XLA's matmul, outside any Pallas kernel). The plain PyTorch versions of
the other kernels are never candidates.

The table: `~/.cache/paddle_tpu_torch/autotune_<card>.json`, `<card>` the
name `torch.cuda.get_device_name()` gives, lower-cased, with every other
character than a letter or a digit made `_`. Entries are keyed by
`op|kernel-version|bucket`; the port's version tags differ from the JAX
package's, so neither package reads the other's measurements. Every
candidate's time is kept, not only the winner's: a bucket rounds its
shape up, and where the winner cannot run the concrete shape, dispatch
takes the fastest candidate that can (`eligible`).
"""
from __future__ import annotations

import json
import os
import threading
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import torch

SCHEMA_VERSION = 1

# the port's own tags: bump when a kernel's code changes enough to make its
# measurements stale
KERNEL_VERSIONS = {
    "matmul": "cu-mm-v2",
    "paged_decode": "cu-pa-v2",
}

# ties go to the library baseline
_KIND_ORDER = {"library": 0, "kernel": 1}


class Candidate(NamedTuple):
    name: str          # e.g. "torch", "cuda:128x256", "grouped"
    kind: str          # "library" (the baseline) | "kernel"
    fn: Callable       # function of the example args
    meta: dict         # what the call site runs: {"impl": ..., ...}


def _mode() -> str:
    from ..framework import config as _config

    m = str(_config.get_flag("FLAGS_autotune", "off")).lower()
    return m if m in ("off", "on", "readonly") else "off"


def mode() -> str:
    return _mode()


def enabled() -> bool:
    return _mode() != "off"


def measurement_allowed() -> bool:
    """False when mode on would time kernels with the default (card)
    timer where there is no card; a custom timer (the tests') lifts it.
    readonly and off never measure anyway."""
    return (_mode() != "on" or torch.cuda.is_available()
            or has_custom_timer())


def device_kind() -> str:
    """The card's name, made a file-name part; "cpu" without a card."""
    kind = torch.cuda.get_device_name() if torch.cuda.is_available() \
        else "cpu"
    return "".join(c if c.isalnum() else "_" for c in kind.lower())


def bucket_pow2(n: int) -> int:
    """Round up to the next power of two (a shape bucket's edge)."""
    n = max(int(n), 1)
    p = 1
    while p < n:
        p *= 2
    return p


# ---------------------------------------------------------------------------
# timers
# ---------------------------------------------------------------------------


def default_timer(fn, args, iters=10, reps=5) -> float:
    """Device time of one `fn(*args)` call in milliseconds.

    `iters` calls are captured in one CUDA graph, and the graph's replays
    are timed with CUDA events; the best of `reps` replays, over `iters`.
    A replay launches the captured kernels back to back without the host,
    so the time is the device's, not that of Python and ctypes launching
    them (CUDA events around a loop of short launches measure the host).
    Two warm calls run first, outside the graph, on a side stream."""
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn(*args)
    graph.replay()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    del graph
    return best


_timer_lock = threading.Lock()
_timer: Callable = default_timer
_timer_is_default = True


def set_timer(timer: Optional[Callable]):
    """Install a timer `timer(fn, args) -> ms` (None: the default device
    timer again). The tests install a deterministic fake."""
    global _timer, _timer_is_default
    with _timer_lock:
        if timer is None:
            _timer = default_timer
            _timer_is_default = True
        else:
            _timer = timer
            _timer_is_default = False


def has_custom_timer() -> bool:
    return not _timer_is_default


# ---------------------------------------------------------------------------
# the tuner
# ---------------------------------------------------------------------------


class Autotuner:
    """One persistent measured-dispatch table per card."""

    def __init__(self, cache_dir: Optional[str] = None,
                 device: Optional[str] = None):
        self._lock = threading.Lock()
        self._mem: Dict[str, dict] = {}
        self._loaded = False
        self._cache_dir = cache_dir
        self._device = device
        # choose_* results by their full call signature: a hit costs one
        # dict lookup, not a rebuild of the candidates
        self._choice_memo: Dict[tuple, object] = {}

    # -- persistence --------------------------------------------------------

    def cache_dir(self) -> str:
        if self._cache_dir:
            return self._cache_dir
        from ..framework import config as _config

        flag_dir = _config.get_flag("FLAGS_autotune_cache_dir", "")
        if flag_dir:
            return flag_dir
        return os.path.join(os.path.expanduser("~"), ".cache",
                            "paddle_tpu_torch")

    def cache_path(self) -> str:
        dev = self._device or device_kind()
        return os.path.join(self.cache_dir(), f"autotune_{dev}.json")

    def _load(self):
        """Read the table once; a missing, unreadable or corrupt file reads
        as an empty table."""
        if self._loaded:
            return
        self._loaded = True
        try:
            with open(self.cache_path()) as f:
                payload = json.load(f)
        except (OSError, ValueError):
            return
        if isinstance(payload, dict) and \
                payload.get("schema_version") == SCHEMA_VERSION and \
                isinstance(payload.get("entries"), dict):
            self._mem.update(payload["entries"])

    def _save(self):
        """Write the table atomically (a temporary file, then a rename, so
        that a kill never leaves half a file). A directory that cannot be
        written keeps the table in memory only."""
        path = self.cache_path()
        payload = {"schema_version": SCHEMA_VERSION,
                   "device_kind": self._device or device_kind(),
                   "entries": self._mem}
        tmp = f"{path}.{os.getpid()}.tmp"
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(tmp, "w") as f:
                json.dump(payload, f, indent=1, sort_keys=True)
            os.replace(tmp, path)
        except OSError:
            pass

    # -- lookup / measurement ----------------------------------------------

    @staticmethod
    def make_key(op: str, bucket: Sequence) -> str:
        ver = KERNEL_VERSIONS.get(op, "v0")
        parts = [f"{k}={v}" for k, v in bucket]
        return "|".join([op, ver] + parts)

    def snapshot(self) -> Dict[str, dict]:
        """A copy of the table."""
        with self._lock:
            self._load()
            return {k: dict(v) for k, v in self._mem.items()}

    def lookup(self, key: str) -> Optional[dict]:
        with self._lock:
            self._load()
            return self._mem.get(key)

    def measure(self, op: str, key: str, candidates: Sequence[Candidate],
                make_args: Callable[[], tuple]) -> dict:
        """Time every candidate on the bucket's example inputs, save and
        return the entry. A candidate that raises makes this raise."""
        timer = _timer
        args = make_args()
        timings = {c.name: float(timer(c.fn, args)) for c in candidates}
        kind = {c.name: c.kind for c in candidates}
        ranked = sorted(timings.items(), key=lambda kv: (
            kv[1], _KIND_ORDER.get(kind[kv[0]], 1)))
        entry = {"winner": ranked[0][0],
                 "timings_ms": {k: round(v, 6) for k, v in timings.items()},
                 "op": op}
        with self._lock:
            self._load()
            self._mem[key] = entry
            self._save()
        return entry

    def pick(self, op: str, bucket: Sequence,
             candidates: Sequence[Candidate],
             make_args: Callable[[], tuple],
             eligible: Optional[Callable[[Candidate], bool]] = None,
             ) -> Optional[Candidate]:
        """The winning candidate of this bucket, or None where the caller
        takes its fixed dispatch (mode off, a readonly miss, no candidate).

        `eligible` says which candidates the concrete call shape can run:
        a bucket rounds shapes up, so the recorded winner may not run the
        live shape; then the fastest recorded eligible candidate wins."""
        m = _mode()
        if m == "off" or not candidates:
            return None
        key = self.make_key(op, bucket)
        entry = self.lookup(key)
        if entry is None:
            if m == "readonly":
                return None
            entry = self.measure(op, key, candidates, make_args)
        by_name = {c.name: c for c in candidates}
        ok = (lambda c: True) if eligible is None else eligible
        win = by_name.get(entry["winner"])
        if win is not None and ok(win):
            return win
        for name, _t in sorted(entry.get("timings_ms", {}).items(),
                               key=lambda kv: kv[1]):
            c = by_name.get(name)
            if c is not None and ok(c):
                return c
        return None


_default_tuner: Optional[Autotuner] = None
_default_lock = threading.Lock()


def get_tuner() -> Autotuner:
    global _default_tuner
    with _default_lock:
        if _default_tuner is None:
            _default_tuner = Autotuner()
        return _default_tuner


def reset_tuner():
    """Drop the process's tuner (the tests; also picks up a changed
    FLAGS_autotune_cache_dir or a table rewritten on disk)."""
    global _default_tuner
    with _default_lock:
        _default_tuner = None


# ---------------------------------------------------------------------------
# the ops' candidates (the call sites stay thin)
# ---------------------------------------------------------------------------


def _memo(key, build):
    """One memo over a choose_* call's full signature: the candidates are
    built, and the table read, at most once per concrete shape."""
    tuner = get_tuner()
    # the mode and the timer are part of the key: a None kept while
    # measurement was not allowed must not outlive a timer install
    key = key + (_mode(), has_custom_timer())
    memo = tuner._choice_memo
    if key in memo:
        return memo[key]
    result = build()
    memo[key] = result
    return result


def choose_matmul(m, k, n, dtype):
    """Measured dispatch of the dense matmul x [m, k] @ w [k, n]
    (`kernels/matmul.py`). Candidates: `torch.matmul` (the baseline, which
    wins ties) and each CUDA kernel variant that takes the bucket's m
    (`matmul.variants`: bf16 "skinny" and "m16" at m <= 16, "128x256" and
    "128x128" above; f32 "m16" and "m64"). Winner meta: {"impl": "torch"}
    or {"impl": "cuda", "tile": variant}."""
    return _memo(("matmul", m, k, n, str(dtype)),
                 lambda: _choose_matmul(m, k, n, dtype))


def _choose_matmul(m, k, n, dtype):
    if not measurement_allowed():
        return None
    from . import matmul as mm

    bm = bucket_pow2(m)
    bucket = (("m", bm), ("k", int(k)), ("n", int(n)),
              ("dt", str(dtype).replace("torch.", "")))
    cands: List[Candidate] = [
        Candidate("torch", "library", torch.matmul, {"impl": "torch"})]
    for tile in mm.variants(dtype, bm):
        def run(x, w, _tile=tile):
            return mm.matmul_fused(x, w, _tile)

        cands.append(Candidate(f"cuda:{tile}", "kernel", run,
                               {"impl": "cuda", "tile": tile}))

    def make_args():
        dev = _example_device()
        gen = torch.Generator(device=dev).manual_seed(5)
        x = torch.randn(bm, k, generator=gen, device=dev).to(dtype)
        w = torch.randn(k, n, generator=gen, device=dev).to(dtype)
        return x, w

    return get_tuner().pick("matmul", bucket, cands, make_args)


def choose_paged_decode(b, n_q_heads, n_kv_heads, head_dim, page_size,
                        pages_per_seq, dtype, quant):
    """Measured dispatch of single-token paged decode
    (`kernels/paged_attention.py`). Candidates: the per-page kernel where
    it takes the head_dim (`supports`) and, for float 16-token pages whose
    table width is a multiple of 8 and with FLAGS_paged_grouped_kernel
    set, the grouped-fetch kernel; the int8 kernel alone for int8 pages.
    No candidate (None) where no kernel takes the shape. Winner meta:
    {"impl": "paged"} or {"impl": "grouped"}."""
    return _memo(
        ("paged_decode", b, n_q_heads, n_kv_heads, head_dim, page_size,
         pages_per_seq, str(dtype), bool(quant)),
        lambda: _choose_paged_decode(b, n_q_heads, n_kv_heads, head_dim,
                                     page_size, pages_per_seq, dtype,
                                     quant))


def _choose_paged_decode(b, n_q_heads, n_kv_heads, head_dim, page_size,
                         pages_per_seq, dtype, quant):
    if not measurement_allowed():
        return None
    from ..framework import config as _config
    from . import paged_attention as pa

    bb = bucket_pow2(b)
    bpps = bucket_pow2(pages_per_seq)
    bucket = (("b", bb), ("qh", int(n_q_heads)), ("kvh", int(n_kv_heads)),
              ("d", int(head_dim)), ("page", int(page_size)),
              ("pps", bpps), ("dt", str(dtype).replace("torch.", "")),
              ("quant", int(bool(quant))))

    def make_args():
        dev = _example_device()
        gen = torch.Generator(device=dev).manual_seed(1)
        n_pages = bb * bpps
        shape = (n_kv_heads, n_pages, page_size, head_dim)
        # int8 pages still decode a float query
        q = torch.randn(bb, n_q_heads, head_dim, generator=gen,
                        device=dev).to(dtype)
        if quant:
            kp, ks = pa._quant_kv_token(torch.randn(shape, generator=gen,
                                                    device=dev))
            vp, vs = pa._quant_kv_token(torch.randn(shape, generator=gen,
                                                    device=dev))
            extra = (ks, vs)
        else:
            kp = torch.randn(shape, generator=gen, device=dev).to(dtype)
            vp = torch.randn(shape, generator=gen, device=dev).to(dtype)
            extra = ()
        tables = torch.arange(n_pages, dtype=torch.int32, device=dev) \
            .reshape(bb, bpps)
        lens = torch.full((bb,), bpps * page_size - 1, dtype=torch.int32,
                          device=dev)
        return (q, kp, vp, tables, lens) + extra

    def paged(q, kp, vp, tb, ln, *scales):
        return pa.paged_attention(q, kp, vp, tb, ln, None, *scales)

    cands = [Candidate("paged", "kernel", paged, {"impl": "paged"})] \
        if pa.supports(head_dim) else []
    if not quant and _config.get_flag("FLAGS_paged_grouped_kernel", False) \
            and pa.grouped_supports(head_dim, page_size, bpps):
        cands.append(Candidate("grouped", "kernel", pa.paged_attention_grouped,
                               {"impl": "grouped"}))

    def eligible(c):
        if c.meta["impl"] == "grouped":
            return pa.grouped_supports(head_dim, page_size, pages_per_seq)
        return True

    return get_tuner().pick("paged_decode", bucket, cands, make_args,
                            eligible)


def _example_device():
    """The card the example inputs are made on; a custom timer (the tests)
    takes them on the CPU."""
    if torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")
