"""Per-op dispatch counters behind FLAGS_benchmark (counterpart of
`paddle_tpu/framework/op_stats.py`), read by
`amp.debugging.disable_operator_stats_collection`."""
from __future__ import annotations

import collections
import threading

_lock = threading.Lock()
_counts: collections.Counter = collections.Counter()


def record(name: str):
    with _lock:
        _counts[name] += 1


def snapshot():
    with _lock:
        return dict(_counts)


def reset():
    with _lock:
        _counts.clear()
