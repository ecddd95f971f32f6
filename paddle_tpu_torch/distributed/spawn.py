"""`paddle.distributed.spawn` (counterpart of
`paddle_tpu/distributed/spawn.py`): run `func(*args)` in nprocs processes,
each with the launch contract of its rank in its environment
(`PADDLE_TRAINER_ID`, `PADDLE_TRAINERS_NUM`, `PADDLE_MASTER`,
`MASTER_ADDR`, `MASTER_PORT`, `PADDLE_LOCAL_RANK`, `PADDLE_LOCAL_SIZE`).

A rank that raises sends its traceback to the parent and exits 1; the
parent then ends the other ranks and raises with every traceback it got.
`timeout` (seconds, port-only option) bounds the whole join: past it the
ranks are killed and TimeoutError raised.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import socket
import time
import traceback

import torch


def free_port() -> int:
    """A TCP port free on this host now (the kernel's pick)."""
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def _worker(func, rank, nprocs, master, args, errors):
    host, port = master.rsplit(":", 1)
    os.environ.update({
        "PADDLE_TRAINER_ID": str(rank),
        "PADDLE_TRAINERS_NUM": str(nprocs),
        "PADDLE_MASTER": master,
        "MASTER_ADDR": host,
        "MASTER_PORT": port,
        "PADDLE_LOCAL_RANK": str(rank),
        "PADDLE_LOCAL_SIZE": str(nprocs),
    })
    try:
        func(*args)
    except BaseException:
        errors.put((rank, traceback.format_exc()))
        raise


def _end(procs):
    for p in procs:
        if p.is_alive():
            p.terminate()
    for p in procs:
        p.join(timeout=5)
        if p.is_alive():
            p.kill()
            p.join()


def spawn(func, args=(), nprocs=-1, join=True, daemon=False, **options):
    """Start `nprocs` ranks (-1: one per visible card, 1 without CUDA) by
    `options["start_method"]` (default "spawn"), the master at
    `options["master"]` or 127.0.0.1 on a free port. With `join`, wait
    for all (at most `options["timeout"]` seconds) and return the
    processes; without, return them running."""
    if nprocs <= 0:
        nprocs = torch.cuda.device_count() if torch.cuda.is_available() \
            else 1
    master = options.get("master") or f"127.0.0.1:{free_port()}"
    ctx = mp.get_context(options.get("start_method", "spawn"))
    errors = ctx.SimpleQueue()
    procs = []
    for rank in range(nprocs):
        p = ctx.Process(target=_worker,
                        args=(func, rank, nprocs, master, args, errors),
                        daemon=daemon)
        p.start()
        procs.append(p)
    if not join:
        return procs
    timeout = options.get("timeout")
    deadline = None if timeout is None else time.monotonic() + timeout
    tbs = []  # read as they come: a rank blocks on a full pipe otherwise
    while any(p.is_alive() for p in procs):
        _drain(errors, tbs)
        if any(p.exitcode not in (None, 0) for p in procs):
            time.sleep(1.0)  # the others' tracebacks, if they are failing
            break
        if deadline is not None and time.monotonic() > deadline:
            _end(procs)
            _drain(errors, tbs)
            raise TimeoutError(
                f"spawn: {nprocs} ranks still running after {timeout} s; "
                "killed" + _format(tbs))
        time.sleep(0.05)
    _end(procs)
    _drain(errors, tbs)
    failed = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode]
    if failed:
        raise RuntimeError(f"spawn workers failed: {failed}" + _format(tbs))
    return procs


def _drain(errors, out):
    while not errors.empty():
        out.append(errors.get())


def _format(tbs):
    return "".join(f"\n--- rank {r}:\n{tb}" for r, tb in sorted(tbs))
