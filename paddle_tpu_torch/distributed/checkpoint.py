"""Distributed checkpoints (counterpart of
`paddle_tpu/distributed/checkpoint.py`): sharded, re-shardable on load,
verified, saved in the background.

The reference writes through orbax, one global array a leaf. Here every
rank of the process group writes only what it holds: a whole tensor (the
first rank that holds a replicated one), or a `LocalPiece` of a whole
tensor (a tensor-parallel shard, a ZeRO slice of one, a pipeline stage's
parameters), recorded at its place in the whole tensor under the whole
state's path. A step's directory holds one `rank<r>.pt` a writing rank
(`torch.save` of its entries), `rank<r>.crc.json` (their crc32) and rank
0's `metadata.json` (the tree, each leaf's dtype, whole shape and pieces).
A load at another layout (other pipeline stages, other tensor-parallel or
ZeRO degrees, one process) reads, for each piece it wants, the saved
pieces that cover it: the reference's reshard-on-load, with the target
layout given by a template of `LocalPiece`s.

The manager's protocol is the reference's: `<dir>/manifests/<step>.json`
holds per-leaf crc32 checksums (a piece's key is its path and its place,
`piece_key`) and optional resume-exact trainer state, and an empty
`<step>.COMMITTED` marker lands only once every rank's write finished;
`restore()` walks steps newest-first, skips uncommitted ones, verifies
checksums, and falls back to the last-known-good step on corruption;
retention never deletes the last-known-good committed step. The
difference: the checksums are computed on the writing thread, so the
manifest lands with the data at the commit (the reference's lands at the
save, its checksums taken before the write).

A save copies what it writes to the host first, then writes on a
background thread (`async_save`), so the step can go on; `wait()` joins
it. Saves, their seconds and bytes, and restore fallbacks are counted on
the manager (`counts`): the reference reports them to its observability
plane, which is not ported.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
import zlib
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist


class CheckpointIntegrityError(RuntimeError):
    """A restored checkpoint failed manifest checksum verification."""


class LocalPiece:
    """A piece of a whole tensor of `shape` that this rank holds: `value`
    is the block `box` ((start, size) per dimension; None: the whole
    tensor), or with `flat` = (lo, hi) the elements lo..hi-1 of that block
    flattened (a ZeRO slice)."""

    __slots__ = ("value", "shape", "box", "flat")

    def __init__(self, value, shape, box=None, flat=None):
        self.value = value
        self.shape = tuple(int(s) for s in shape)
        self.box = tuple((0, s) for s in self.shape) if box is None \
            else tuple((int(a), int(n)) for a, n in box)
        self.flat = None if flat is None else (int(flat[0]), int(flat[1]))

    def __repr__(self):
        return (f"LocalPiece(shape={self.shape}, box={self.box}, "
                f"flat={self.flat})")


def piece_key(path, box, flat, shape):
    """The manifest's key of a piece: its path and its place (the path
    alone for a whole tensor of `shape`)."""
    if flat is None and all(a == 0 and n == s for (a, n), s in
                            zip(box, shape)):
        return path
    where = ",".join(f"{a}+{n}" for a, n in box)
    return f"{path}@{where}" + ("" if flat is None else
                                f"[{flat[0]}:{flat[1]}]")


# ---------------------------------------------------------------------------
# trees


def _walk(obj, path=()):
    """(path, leaf) of every leaf of a nested dict / list (sorted keys)."""
    if isinstance(obj, dict):
        for k in sorted(obj, key=str):
            yield from _walk(obj[k], path + (str(k),))
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            yield from _walk(v, path + (str(i),))
    else:
        yield "/".join(path), obj


def _skeleton(obj, path=()):
    """The tree with each leaf replaced by {"@leaf": its path}; dict keys
    as strings, lists as lists."""
    if isinstance(obj, dict):
        return {str(k): _skeleton(v, path + (str(k),)) for k, v in
                obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_skeleton(v, path + (str(i),)) for i, v in enumerate(obj)]
    return {"@leaf": "/".join(path)}


def _merge(a, b):
    """Two ranks' skeletons joined (each holds a part of the tree)."""
    if isinstance(a, dict) and isinstance(b, dict) and "@leaf" not in a:
        out = dict(a)
        for k, v in b.items():
            out[k] = _merge(out[k], v) if k in out else v
        return out
    if isinstance(a, list) and isinstance(b, list):
        return [_merge(x, y) for x, y in zip(a, b)] + \
            (a[len(b):] if len(a) > len(b) else b[len(a):])
    return a


def _is_tensor(x):
    return isinstance(x, (torch.Tensor, np.ndarray)) or (
        hasattr(x, "dtype") and hasattr(x, "shape") and np.ndim(x) > 0)


def _dtype_name(t):
    if isinstance(t, torch.Tensor):
        return str(t.dtype).replace("torch.", "")
    return str(np.asarray(t).dtype)


def _host(t):
    """A contiguous CPU copy of tensor `t` (a numpy array as a tensor)."""
    if isinstance(t, np.ndarray) or not isinstance(t, torch.Tensor):
        a = np.asarray(t)
        if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: its bits
            return torch.from_numpy(a.view(np.uint16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(np.array(a, copy=True))
    return t.detach().to("cpu", copy=True).contiguous()


def _crc(t):
    """crc32 of a contiguous CPU tensor's bytes."""
    if t.numel() == 0:
        return 0
    raw = t.reshape(-1).view(torch.uint8).numpy()
    return zlib.crc32(memoryview(raw)) & 0xFFFFFFFF


def _leaf_checksums(arrays) -> Dict[str, dict]:
    """Deterministic path -> {crc, dtype, shape} over a tree of tensors or
    arrays (dict / list nesting, sorted dict keys): the reference's
    manifest entries, the same for the same values."""
    out: Dict[str, dict] = {}
    for path, leaf in _walk(arrays):
        if isinstance(leaf, LocalPiece):
            t = _host(leaf.value)
            out[piece_key(path, leaf.box, leaf.flat, leaf.shape)] = {
                "crc": _crc(t), "dtype": _dtype_name(leaf.value),
                "shape": list(t.shape)}
        elif _is_tensor(leaf):
            t = _host(leaf)
            out[path] = {"crc": _crc(t), "dtype": _dtype_name(leaf),
                         "shape": list(t.shape)}
    return out


def _json_value(v):
    return v.item() if isinstance(v, np.generic) else v


# ---------------------------------------------------------------------------
# the process group


def _world():
    """(rank, world size) of the process group; (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _gather(obj):
    rank, world = _world()
    if world == 1:
        return [obj]
    out = [None] * world
    dist.all_gather_object(out, obj)
    return out


def _barrier():
    if _world()[1] > 1:
        dist.barrier()


# ---------------------------------------------------------------------------
# the writer


class _Save:
    """One save of a state to `path`: planned and copied to the host on
    the caller's thread (the collectives run there), written by `run`.
    Where ranks name the same piece, they must hold the same tensor (local
    shape, dtype, crc32) and the same scalar: a name two ranks use for
    different values raises ValueError on every rank, before anything is
    written."""

    def __init__(self, state_dict, path):
        self.path = os.path.abspath(path)
        self.rank, self.world = _world()
        entries, values = [], {}
        for leaf_path, leaf in _walk(state_dict):
            if isinstance(leaf, LocalPiece):
                entries.append((leaf_path, _dtype_name(leaf.value),
                                leaf.shape, leaf.box, leaf.flat,
                                tuple(leaf.value.shape), leaf.value))
            elif _is_tensor(leaf):
                shape = tuple(leaf.shape)
                box = tuple((0, s) for s in shape)
                entries.append((leaf_path, _dtype_name(leaf), shape, box,
                                None, shape, leaf))
            else:
                values[leaf_path] = _json_value(leaf)
        mine = [e[:6] for e in entries]
        every = _gather((mine, values, _skeleton(state_dict)))
        # the writer of each piece: the first rank that holds it
        leaves, holders, value_of = {}, {}, {}
        tree, all_values = None, {}
        for r, (ents, vals, skel) in enumerate(every):
            tree = skel if tree is None else _merge(tree, skel)
            for k, v in vals.items():
                if k in all_values and json.dumps(v) != value_of[k]:
                    raise ValueError(
                        f"checkpoint {self.path}: rank {r} saves {k} = "
                        f"{v!r}, an earlier rank {all_values[k]!r}")
                all_values.setdefault(k, v)
                value_of.setdefault(k, json.dumps(v))
            for lp, dtype, shape, box, flat, local in ents:
                key = piece_key(lp, box, flat, shape)
                held = (tuple(shape), dtype, tuple(local))
                if key in holders:
                    first, was = holders[key][0], holders[key][1]
                    if held != was:
                        raise ValueError(
                            f"checkpoint {self.path}: ranks {first} and {r}"
                            f" both save {key}, as (whole shape, dtype, "
                            f"local shape) {was} and {held}: one name for "
                            "two tensors")
                    holders[key][2] += 1
                    continue
                holders[key] = [r, held, 1]
                meta = leaves.setdefault(lp, {"dtype": dtype,
                                              "shape": list(shape),
                                              "pieces": []})
                meta["pieces"].append({
                    "rank": r, "key": key, "box": [list(b) for b in box],
                    "flat": None if flat is None else list(flat),
                    "local": list(local)})
        shared = {k for k, h in holders.items() if h[2] > 1}
        host = {}
        for lp, dtype, shape, box, flat, local, value in entries:
            key = piece_key(lp, box, flat, shape)
            if holders[key][0] == self.rank or key in shared:
                host[key] = _host(value)
        # the pieces several ranks hold: every copy the same bytes
        self.known_crcs = {k: _crc(host[k]) for k in shared if k in host}
        if shared:
            first = {}
            for r, crcs in enumerate(_gather(self.known_crcs)):
                for k, c in crcs.items():
                    if first.setdefault(k, (r, c))[1] != c:
                        raise ValueError(
                            f"checkpoint {self.path}: ranks {first[k][0]} "
                            f"and {r} both save {k} with different values "
                            "(crc32): one name for two tensors")
        self.metadata = {"format": 1, "world": self.world, "tree": tree,
                         "leaves": leaves, "values": all_values}
        self.tensors = {k: t for k, t in host.items()
                        if holders[k][0] == self.rank}
        self.nbytes = sum(t.numel() * t.element_size()
                          for t in self.tensors.values())
        self.crcs = None
        self.error = None

    def prepare(self, overwrite=True):
        """The directory made (emptied first where `overwrite`); rank 0's
        metadata written."""
        if self.rank == 0:
            if os.path.exists(self.path):
                if not overwrite:
                    raise FileExistsError(f"checkpoint {self.path} exists")
                shutil.rmtree(self.path)
            os.makedirs(self.path)
        _barrier()
        if self.rank == 0:
            _write_json(os.path.join(self.path, "metadata.json"),
                        self.metadata)

    def run(self):
        """Write this rank's entries and their crc32 (on any thread)."""
        try:
            crcs = {k: self.known_crcs[k] if k in self.known_crcs
                    else _crc(t) for k, t in self.tensors.items()}
            if self.tensors:
                tmp = os.path.join(self.path, f"rank{self.rank}.pt.tmp")
                torch.save(self.tensors, tmp)
                os.replace(tmp, os.path.join(self.path,
                                             f"rank{self.rank}.pt"))
            _write_json(os.path.join(self.path,
                                     f"rank{self.rank}.crc.json"), crcs)
            self.crcs = crcs
        except BaseException as e:  # handed to the caller on join
            self.error = e
        finally:
            self.tensors = {}


def _write_json(path, obj):
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(obj, f, sort_keys=True)
    os.replace(tmp, path)


def _read_json(path):
    try:
        with open(path, encoding="utf-8") as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _checksums(path, metadata):
    """{piece key: {crc, dtype, shape}} of a finished save at `path`,
    from every writing rank's crc file."""
    crcs = {}
    for r in range(int(metadata.get("world", 1))):
        got = _read_json(os.path.join(path, f"rank{r}.crc.json"))
        if got:
            crcs.update(got)
    out = {}
    for lp, meta in metadata["leaves"].items():
        for pc in meta["pieces"]:
            if pc["key"] in crcs:
                out[pc["key"]] = {"crc": crcs[pc["key"]],
                                  "dtype": meta["dtype"],
                                  "shape": pc["local"]}
    return out


def save_state_dict(state_dict, path, overwrite=True):
    """Blocking sharded save of a (nested) state_dict to `path`: a
    collective over the process group where there is one (each rank
    passes what it holds: whole tensors, `LocalPiece`s, scalars)."""
    job = _Save(state_dict, path)
    job.prepare(overwrite)
    job.run()
    if job.error is not None:
        raise job.error
    _barrier()
    return job


# ---------------------------------------------------------------------------
# the reader


_TORCH_DTYPES = {"float32": torch.float32, "float64": torch.float64,
                 "bfloat16": torch.bfloat16, "float16": torch.float16,
                 "int64": torch.int64, "int32": torch.int32,
                 "int8": torch.int8, "uint8": torch.uint8,
                 "bool": torch.bool}


class _Reader:
    """A finished save at `path`: its metadata; each rank file opened once
    (memory-mapped); pieces read and, with `verify`, checked against
    `checksums` (each piece once)."""

    def __init__(self, path, checksums=None):
        self.path = os.path.abspath(path)
        self.meta = _read_json(os.path.join(self.path, "metadata.json"))
        if self.meta is None:
            raise FileNotFoundError(f"no checkpoint metadata under "
                                    f"{self.path}")
        self.checksums = checksums
        self._files = {}
        self._checked = set()
        self.nbytes = 0

    def _entry(self, pc):
        r = pc["rank"]
        if r not in self._files:
            f = os.path.join(self.path, f"rank{r}.pt")
            self._files[r] = torch.load(f, map_location="cpu", mmap=True,
                                        weights_only=True)
        t = self._files[r][pc["key"]]
        if self.checksums is not None and pc["key"] not in self._checked:
            want = self.checksums.get(pc["key"])
            if want is None or _crc(t.contiguous()) != want["crc"]:
                raise CheckpointIntegrityError(
                    f"{self.path}: checksum mismatch on {pc['key']}")
            self._checked.add(pc["key"])
        self.nbytes += t.numel() * t.element_size()
        return t

    def leaf(self, lp, box=None, flat=None):
        """The saved leaf `lp` cut to `box` (None: whole) and `flat` of
        that block (None: all of it), as a new CPU tensor."""
        meta = self.meta["leaves"][lp]
        shape = tuple(meta["shape"])
        box = tuple((0, s) for s in shape) if box is None else tuple(
            tuple(b) for b in box)
        bshape = tuple(n for _, n in box)
        numel = int(np.prod(bshape)) if bshape else 1
        lo, hi = (0, numel) if flat is None else flat
        dtype = _TORCH_DTYPES[meta["dtype"]]
        same = [pc for pc in meta["pieces"]
                if tuple(tuple(b) for b in pc["box"]) == box]
        out = torch.empty(hi - lo, dtype=dtype)
        seen = np.zeros(hi - lo, dtype=bool)
        for pc in same:  # the same block: copy the flat overlaps
            plo, phi = pc["flat"] or (0, numel)
            a, b = max(lo, plo), min(hi, phi)
            if a < b:
                t = self._entry(pc).reshape(-1)
                out[a - lo:b - lo] = t[a - plo:b - plo]
                seen[a - lo:b - lo] = True
        if not seen.all():
            whole = self._whole(lp, meta, shape, dtype)
            block = whole[tuple(slice(s, s + n) for s, n in box)]
            out = block.reshape(-1)[lo:hi].clone()
        if flat is None:
            out = out.reshape(bshape)
        return out

    def _whole(self, lp, meta, shape, dtype):
        whole = torch.empty(shape, dtype=dtype)
        seen = np.zeros(shape, dtype=bool)
        for pc in meta["pieces"]:
            box = tuple(tuple(b) for b in pc["box"])
            sl = tuple(slice(s, s + n) for s, n in box)
            t = self._entry(pc).reshape(-1)
            if pc["flat"] is None:
                whole[sl] = t.reshape(tuple(n for _, n in box))
                seen[sl] = True
            else:
                plo, phi = pc["flat"]
                block = whole[sl].clone().reshape(-1)
                block[plo:phi] = t
                whole[sl] = block.reshape(tuple(n for _, n in box))
                mark = seen[sl].reshape(-1).copy()
                mark[plo:phi] = True
                seen[sl] = mark.reshape(seen[sl].shape)
        if not seen.all():
            raise CheckpointIntegrityError(
                f"{self.path}: the pieces of {lp} do not cover it")
        return whole


def _restore(reader, template, return_tensors):
    """The saved tree (every leaf whole) or `template`'s tree with each
    leaf read at the template's layout (a `LocalPiece` filled with the
    values of its place)."""
    values = reader.meta["values"]

    def out(t):
        if return_tensors:
            return t
        if t.dtype == torch.bfloat16:
            return t.float().numpy()
        return t.numpy()

    def fill(node, path):
        if isinstance(node, dict):
            return {k: fill(v, path + (str(k),)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [fill(v, path + (str(i),)) for i, v in enumerate(node)]
        lp = "/".join(path)
        if isinstance(node, LocalPiece):
            return LocalPiece(out(reader.leaf(lp, node.box, node.flat)),
                              node.shape, node.box, node.flat)
        if lp in reader.meta["leaves"]:
            return out(reader.leaf(lp))
        if lp in values:
            return values[lp]
        raise KeyError(f"{reader.path}: no leaf {lp!r}")

    def build(node):
        if isinstance(node, dict) and "@leaf" not in node:
            return {k: build(v) for k, v in node.items()}
        if isinstance(node, list):
            return [build(v) for v in node]
        lp = node["@leaf"]
        if lp in reader.meta["leaves"]:
            return out(reader.leaf(lp))
        return values.get(lp)

    if template is None:
        return build(reader.meta["tree"])
    return fill(template, ())


def _spec_template(template, mesh, spec_fn):
    """`template` with each leaf that `spec_fn(path, leaf)` names mesh
    axes for replaced by this rank's block of it (each named dimension cut
    evenly over its axis)."""
    def cut(path, leaf):
        spec = spec_fn(path, leaf)
        if spec is None or not _is_tensor(leaf):
            return leaf
        shape = tuple(leaf.shape)
        box = []
        for d, n in enumerate(shape):
            ax = spec[d] if d < len(spec) else None
            if ax is None:
                box.append((0, n))
                continue
            size = int(mesh[ax].size())
            r = int(mesh.get_local_rank(ax))
            box.append((r * (n // size), n // size))
        return LocalPiece(leaf, shape, box)

    def rec(node, path):
        if isinstance(node, dict):
            return {k: rec(v, path + (str(k),)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [rec(v, path + (str(i),)) for i, v in enumerate(node)]
        return cut("/".join(path), node)

    return rec(template, ())


def load_state_dict(path, template=None, mesh=None, spec_fn=None,
                    return_tensors=True):
    """Restore a state_dict saved by `save_state_dict`. Without
    `template`, the saved tree with every leaf whole. With one (a tree of
    tensors, scalars and `LocalPiece`s), that tree, each leaf read at the
    template's layout: a piece gets the values of its place, whatever
    layout the save had (reshard on load). `mesh` (a DeviceMesh) and
    `spec_fn(name, array) -> spec or None` cut each template leaf the spec
    names into this rank's block (a `LocalPiece`). Tensors come back on
    the CPU (numpy arrays without `return_tensors`)."""
    if spec_fn is not None and template is None:
        raise ValueError(
            "reshard-on-load (spec_fn) needs a `template` state_dict to "
            "know the tree structure")
    if spec_fn is not None:
        template = _spec_template(template, mesh, spec_fn)
    return _restore(_Reader(path), template, return_tensors)


# ---------------------------------------------------------------------------
# resume-exact trainer state


def trainer_state_snapshot(step: int, data_position=None, stream=None):
    """Resume-exact trainer state for a manifest: the global step, the
    random stream's state (the port's `torch.Generator`: its state bytes
    and the global seed), and an opaque dataloader position.
    JSON-serializable by construction."""
    from ..framework import random as _random

    gen = stream if stream is not None else _random._current()
    state = gen.get_state()
    return {
        "step": int(step),
        "rng": {"generator_state": [int(b) for b in state.tolist()],
                "seed": int(_random.get_seed())},
        "data_position": data_position,
    }


def apply_trainer_state(snapshot, stream=None):
    """Install a `trainer_state_snapshot()`: the stream draws what the
    saved run would have drawn next. Returns the snapshot (callers read
    step / data_position from it)."""
    from ..framework import random as _random

    rng = snapshot.get("rng")
    if rng:
        gen = stream if stream is not None else _random._current()
        if stream is None and "seed" in rng:
            _random._seed = int(rng["seed"])
        gen.set_state(torch.tensor(rng["generator_state"],
                                   dtype=torch.uint8))
    return snapshot


# ---------------------------------------------------------------------------
# the manager


class CheckpointManager:
    """Periodic checkpoints with retention, two-phase commit and
    verify-on-restore (the module's docstring):

    mgr = CheckpointManager(dir, max_to_keep=3, save_interval_steps=100)
    mgr.save(step, state_dict)        # async: returns once on the host
    state = mgr.restore(step=None)    # newest COMMITTED + verified step
    mgr.wait(); mgr.close()

    Every rank of the process group calls each method in the same order
    (a save and a commit are collectives); rank 0 writes the manifests
    and markers and prunes. The COMMITTED marker lands once every rank's
    write finished: at the next save(), wait(), restore() or close().
    Retention keeps the newest max_to_keep steps plus the last-known-good
    committed step."""

    def __init__(self, directory, max_to_keep: int = 5,
                 save_interval_steps: int = 1, async_save: bool = True):
        self._dir = os.path.abspath(os.fspath(directory))
        self._manifest_dir = os.path.join(self._dir, "manifests")
        self._rank = _world()[0]
        if self._rank == 0:
            os.makedirs(self._manifest_dir, exist_ok=True)
        _barrier()
        self._max_to_keep = max_to_keep
        self._interval = max(int(save_interval_steps), 1)
        self._async = bool(async_save)
        self._pending: Optional[tuple] = None
        self.counts = {"saves": 0, "save_seconds": 0.0, "save_bytes": 0,
                       "restore_fallbacks": 0, "restore_bytes": 0,
                       "restore_seconds": 0.0}

    # -- layout --------------------------------------------------------------

    def _step_dir(self, step: int) -> str:
        return os.path.join(self._dir, str(int(step)))

    def _manifest_path(self, step: int) -> str:
        return os.path.join(self._manifest_dir, f"{int(step)}.json")

    def _committed_path(self, step: int) -> str:
        return os.path.join(self._manifest_dir, f"{int(step)}.COMMITTED")

    def is_committed(self, step: int) -> bool:
        return os.path.exists(self._committed_path(step))

    def committed_steps(self) -> List[int]:
        return sorted(s for s in self.all_steps() if self.is_committed(s))

    def last_known_good(self) -> Optional[int]:
        """Newest step with a COMMITTED marker (after flushing any
        pending commit)."""
        self._flush_commit()
        steps = self.committed_steps()
        return steps[-1] if steps else None

    def manifest(self, step: int) -> Optional[dict]:
        return _read_json(self._manifest_path(step))

    # -- save / commit -------------------------------------------------------

    def save(self, step: int, state_dict, force: bool = False,
             trainer_state: Optional[dict] = None) -> bool:
        """Save `state_dict` as `step` (unless `should_save` says no and
        not `force`): copied to the host now, written in the background
        (`async_save`), committed later. Returns whether it saved."""
        self._flush_commit()
        if not force and not self.should_save(step):
            return False
        t0 = time.perf_counter()
        job = _Save(state_dict, self._step_dir(step))
        job.prepare(overwrite=True)
        thread = None
        if self._async:
            thread = threading.Thread(target=job.run, daemon=True)
            thread.start()
        else:
            job.run()
        self._pending = (int(step), job, thread, trainer_state)
        self.counts["saves"] += 1
        self.counts["save_seconds"] += time.perf_counter() - t0
        self.counts["save_bytes"] += job.nbytes
        return True

    def _flush_commit(self):
        """Land the manifest and the COMMITTED marker of the last save once
        every rank's write finished, then prune."""
        if self._pending is None:
            return
        step, job, thread, trainer_state = self._pending
        self._pending = None
        t0 = time.perf_counter()
        if thread is not None:
            thread.join()
        ok = job.error is None
        oks = _gather(ok)
        self.counts["save_seconds"] += time.perf_counter() - t0
        if not all(oks):
            if job.error is not None:
                raise job.error
            raise RuntimeError(f"checkpoint step {step}: a rank's write "
                               "failed; the step is left uncommitted")
        if self._rank == 0:
            manifest = {"format": 1, "step": int(step),
                        "checksums": _checksums(job.path, job.metadata)}
            if trainer_state is not None:
                manifest["trainer_state"] = trainer_state
            _write_json(self._manifest_path(step), manifest)
            self._commit(step)
            self._prune()
        _barrier()

    def _commit(self, step):
        open(self._committed_path(step), "w").close()

    def _prune(self):
        """Keep the newest max_to_keep steps PLUS the last-known-good
        committed step (rank 0)."""
        if not self._max_to_keep or self._max_to_keep <= 0:
            return
        steps = self.all_steps()
        keep = set(steps[-self._max_to_keep:])
        committed = [s for s in steps if self.is_committed(s)]
        if committed:
            keep.add(committed[-1])
        for s in steps:
            if s in keep:
                continue
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
            for path in (self._manifest_path(s), self._committed_path(s)):
                try:
                    os.remove(path)
                except OSError:
                    pass

    # -- restore / verify ----------------------------------------------------

    def restore(self, step: Optional[int] = None, template=None,
                mesh=None, spec_fn=None, return_tensors=True,
                verify: bool = True):
        """Restore a state_dict (at `template`'s layout, as
        `load_state_dict`). step=None walks steps newest-first:
        uncommitted (torn) steps are skipped and checksum failures fall
        back to the next older committed step, both counted in
        `counts["restore_fallbacks"]`. An explicit step restores exactly
        that step (verified when its manifest exists) and raises
        CheckpointIntegrityError on a mismatch."""
        self._flush_commit()
        if spec_fn is not None and template is None:
            raise ValueError(
                "reshard-on-load (spec_fn) needs a `template` state_dict")
        if spec_fn is not None:
            template = _spec_template(template, mesh, spec_fn)
        if step is not None:
            return self._restore_step(step, template, return_tensors,
                                      verify)
        steps = sorted(self.all_steps(), reverse=True)
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {self._dir}")
        managed = any(os.path.exists(self._manifest_path(s))
                      for s in steps)
        failures = []
        for s in steps:
            if managed and not self.is_committed(s):
                self.counts["restore_fallbacks"] += 1
                failures.append(f"step {s}: no COMMITTED marker "
                                f"(torn/unfinished write)")
                continue
            try:
                return self._restore_step(s, template, return_tensors,
                                          verify and managed)
            except CheckpointIntegrityError as e:
                self.counts["restore_fallbacks"] += 1
                failures.append(str(e))
        raise FileNotFoundError(
            f"no restorable checkpoint under {self._dir}: "
            + "; ".join(failures))

    def _restore_step(self, step, template, return_tensors, verify):
        t0 = time.perf_counter()
        checksums = None
        if verify:
            manifest = self.manifest(step)
            if manifest is None and os.path.exists(
                    self._manifest_path(step)):
                raise CheckpointIntegrityError(
                    f"step {step}: manifest unreadable (torn write?)")
            if manifest is not None:
                checksums = manifest.get("checksums", {})
        reader = _Reader(self._step_dir(step), checksums)
        if checksums is not None:
            saved = {pc["key"] for meta in reader.meta["leaves"].values()
                     for pc in meta["pieces"]}
            missing = sorted(set(checksums) ^ saved)
            if missing:
                raise CheckpointIntegrityError(
                    f"step {step}: checksum mismatch on {missing[:4]} "
                    f"({len(missing)} missing)")
        out = _restore(reader, template, return_tensors)
        self.counts["restore_bytes"] += reader.nbytes
        self.counts["restore_seconds"] += time.perf_counter() - t0
        return out

    def restore_trainer_state(self, step: Optional[int] = None
                              ) -> Optional[dict]:
        """The resume-exact snapshot from the newest committed manifest
        carrying one (or from `step`'s). None when no manifest has trainer
        state."""
        self._flush_commit()
        candidates = [step] if step is not None else \
            sorted(self.committed_steps(), reverse=True)
        for s in candidates:
            m = self.manifest(s)
            if m and m.get("trainer_state") is not None:
                return m["trainer_state"]
        return None

    # -- steps -----------------------------------------------------------------

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self):
        """Every step with a directory (the one being written included)."""
        if not os.path.isdir(self._dir):
            return []
        return sorted(int(n) for n in os.listdir(self._dir) if n.isdigit()
                      and os.path.isdir(os.path.join(self._dir, n)))

    def should_save(self, step: int) -> bool:
        """Any step before the first save; after it, a later step on the
        save interval (orbax's rule, which the reference takes)."""
        last = self.latest_step()
        if last is None:
            return True
        return int(step) > last and int(step) % self._interval == 0

    def wait(self):
        self._flush_commit()

    def close(self):
        self._flush_commit()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# model / optimizer (fleet.save / fleet.load_model)


def _model_state(model, optimizer=None):
    """The state `save_model_state` writes: {"model": each parameter (and
    buffer) as this rank holds it, under the whole model's names
    (`weights.param_pieces`: tensor-parallel shards, pipeline stages and
    ZeRO stage-3 pieces as `LocalPiece`s)}, and with `optimizer`
    {"optimizer": {"step", "LR_Scheduler" where it has one, "state":
    {parameter name: {state name: the rank's state (a `LocalPiece` at the
    parameter's place; under ZeRO the piece of its slice), or a
    scalar}}}}."""
    from ..weights import param_pieces

    pieces = param_pieces(model)
    out = {"model": {n: LocalPiece(v, shape, box, flat)
                     for n, (v, shape, box, flat) in pieces.items()}}
    if optimizer is not None:
        out["optimizer"] = _optimizer_state(model, optimizer, pieces)
    return out


def _optimizer_state(model, optimizer, pieces):
    from ..optimizer.lr import LRScheduler
    from ..weights import param_names
    from .fleet.meta_parallel.sharding.group_sharded import engine_of

    inner = getattr(optimizer, "_inner_opt", optimizer)
    params = inner._parameter_list or []
    names = param_names(model)
    zero = engine_of(params)
    state = {}
    for i, st in sorted(inner._accumulators.items()):
        p = params[i]
        flat = zero.piece_range(p) if zero is not None else None
        for n in names[id(p)]:
            _, shape, box, _ = pieces[n]
            entry = {}
            for k, v in st.items():
                if isinstance(v, torch.Tensor) and v.dim() > 0:
                    entry[k] = LocalPiece(v, shape, box, flat)
                else:
                    entry[k] = _json_value(v)
            state[n] = entry
    out = {"step": int(inner._step_count), "state": state}
    if isinstance(inner._lr, LRScheduler):
        out["LR_Scheduler"] = inner._lr.state_dict()
    return out


@torch.no_grad()
def _apply_model_state(model, optimizer, state):
    """Copy a restored `_model_state` tree (read at this rank's layout)
    into `model`'s parameters and `optimizer`'s state."""
    from ..weights import param_names, set_param_pieces

    set_param_pieces(model, {n: pc.value if isinstance(pc, LocalPiece)
                             else pc for n, pc in state["model"].items()})
    if optimizer is None or "optimizer" not in state:
        return
    saved = state["optimizer"]
    inner = getattr(optimizer, "_inner_opt", optimizer)
    inner._step_count = int(saved.get("step", 0))
    if "LR_Scheduler" in saved and hasattr(inner._lr, "set_state_dict"):
        inner._lr.set_state_dict(saved["LR_Scheduler"])
    params = inner._parameter_list or []
    names = param_names(model)
    for i, st in inner._accumulators.items():
        got = saved["state"].get(names[id(params[i])][0])
        if got is None:
            continue
        for k, cur in list(st.items()):
            if k not in got:
                continue
            v = got[k]
            v = v.value if isinstance(v, LocalPiece) else v
            if isinstance(cur, torch.Tensor):
                cur.copy_(torch.as_tensor(v).reshape(cur.shape).to(
                    cur.device, cur.dtype))
            else:
                st[k] = type(cur)(v)


def _init_optimizer_state(model, optimizer):
    """Every state entry the optimizer would hold after a step (under ZeRO
    the rank's pieces), so that a restore has a layout to fill."""
    from .fleet.meta_parallel.sharding.group_sharded import engine_of

    inner = getattr(optimizer, "_inner_opt", optimizer)
    params = inner._parameter_list or []
    zero = engine_of(params)
    if zero is not None:
        zero.init_states()
    else:
        for i, p in enumerate(params):
            if p.requires_grad:
                inner._state_for(i)


def save_model_state(model, optimizer, path, overwrite=True):
    """`model`'s parameters (and `optimizer`'s state) as one checkpoint at
    `path`, every rank writing what it holds (`_model_state`)."""
    save_state_dict(_model_state(model, optimizer), path,
                    overwrite=overwrite)


def load_model_state(model, optimizer, path, mesh=None, spec_fn=None):
    """Read a `save_model_state` checkpoint into `model` (and
    `optimizer`) at their own layout, whatever layout the save had: each
    rank reads the places of what it holds. The target layout is the
    model's (its stage, shards and pieces), so `mesh` and `spec_fn` must
    be None. Returns the restored tree."""
    if mesh is not None or spec_fn is not None:
        raise ValueError(
            "load_model_state: the target layout is the model's own (its "
            "pipeline stage, tensor-parallel shards and ZeRO pieces); "
            "mesh and spec_fn are for load_state_dict")
    if optimizer is not None:
        _init_optimizer_state(model, optimizer)
    template = _model_state(model, optimizer)
    if optimizer is not None and "optimizer" not in \
            _Reader(path).meta["tree"]:
        template.pop("optimizer")
    out = load_state_dict(path, template=template)
    _apply_model_state(model, optimizer, out)
    return out


__all__ = ["CheckpointIntegrityError", "CheckpointManager", "LocalPiece",
           "apply_trainer_state", "load_model_state", "load_state_dict",
           "save_model_state", "save_state_dict", "trainer_state_snapshot"]
