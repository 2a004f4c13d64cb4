"""Atomic checkpoints in the reference's on-disk layout.

Layout::

    <dir>/step_000123/
        manifest.json          # leaf shapes, dtypes, integrity hashes,
                               # leaf key paths, loader cursor (extra)
        leaf_00000.npy ...     # one file per tree leaf (np arrays)
        _COMMITTED             # written last: atomic-commit marker

The files are the reference's, so either side restores what the other
saved:

* leaves are numbered in the reference's flatten order: dict keys sorted
  at every level, lists and tuples in order, ``None`` giving no leaf
  (:func:`repro_torch.params.tree_flatten`). A train state
  ``(params, opt_state, err)`` is therefore the params (sorted), then
  ``count``, ``m`` and ``v``, then ``err`` when compression is on;
* the manifest's ``treedef`` is ``null``: the reference writes its own
  tree library's repr there and accepts ``null`` as "not recorded". The
  port records its leaves' key paths (``"0/convs/0/b"``) under
  ``leaf_paths`` instead, which the reference ignores.

Fault-tolerance contract: a save is atomic (a crash mid-save leaves no
``_COMMITTED`` marker and restore ignores the partial directory), and
restore picks the newest committed step <= the requested one.

Across ranks (a default process group of more than one rank): every rank
calls :func:`save`, DTensor leaves are gathered to full tensors on every
rank, rank 0 alone writes, and all ranks wait for its commit before
returning. :func:`restore` with ``shardings`` places each leaf as a
DTensor on the given mesh, each rank keeping its own shard.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.params import (to_numpy, tree_flatten_with_paths,
                                 tree_unflatten)
from repro_torch.runtime import sharding as SH

COMMIT_MARKER = "_COMMITTED"


def _ranks() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def save(directory: str, step: int, tree, *, extra: Optional[Dict] = None,
         keep: int = 3) -> str:
    """Atomic checkpoint save. Returns the committed path."""
    final = os.path.join(directory, f"step_{step:09d}")
    flat = [(path, leaf.full_tensor() if isinstance(leaf, SH.DTensor)
             else leaf) for path, leaf in tree_flatten_with_paths(tree)]
    if _ranks() > 1:
        if dist.get_rank() == 0:
            _write(directory, final, step, flat, extra, keep)
        dist.barrier()
        return final
    return _write(directory, final, step, flat, extra, keep)


def _write(directory, final, step, flat, extra, keep) -> str:
    os.makedirs(directory, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=".tmp_ckpt_", dir=directory)
    manifest = {"step": step, "n_leaves": len(flat), "treedef": None,
                "leaf_paths": [path for path, _ in flat],
                "extra": extra or {}, "leaves": []}
    for i, (_, leaf) in enumerate(flat):
        arr = to_numpy(leaf)
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"].append({
            "file": fname, "shape": list(arr.shape), "dtype": str(arr.dtype),
            "sha1": hashlib.sha1(arr.tobytes()).hexdigest()})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp, COMMIT_MARKER), "w") as f:
        f.write("ok")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(directory, keep)
    return final


def _gc(directory: str, keep: int):
    steps = sorted(latest_steps(directory))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s:09d}"),
                      ignore_errors=True)


def latest_steps(directory: str):
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if name.startswith("step_") and os.path.exists(
                os.path.join(directory, name, COMMIT_MARKER)):
            out.append(int(name[5:]))
    return sorted(out)


def restore(directory: str, like, *, step: Optional[int] = None,
            shardings=None, verify: bool = False,
            check_treedef: bool = True) -> Tuple[Any, int, Dict]:
    """Restore the newest committed checkpoint into the structure of
    ``like``; each leaf comes back as a tensor with the dtype and on the
    device of ``like``'s leaf in its place.

    shardings: optional tree of ``(mesh, placements)`` pairs matching
    ``like`` (``sharding.tree_shardings``): each leaf comes back as a
    DTensor placed so on that mesh (elastic re-shard onto the current
    mesh). Without it, a DTensor leaf of ``like`` gives its own mesh and
    placements.

    Leaves are matched by flatten order, so structure drift must fail
    loudly rather than permute weights: the leaf count and every leaf's
    shape are always checked (a single-head checkpoint does not restore
    into a multi-head tree), and with ``check_treedef`` so are the key
    paths where the checkpoint recorded them (the port's do; the
    reference's record a ``treedef`` the port cannot read, and it is
    not compared)."""
    steps = latest_steps(directory)
    if step is not None:
        steps = [s for s in steps if s <= step]
    if not steps:
        raise FileNotFoundError(f"no committed checkpoints in {directory}")
    chosen = steps[-1]
    path = os.path.join(directory, f"step_{chosen:09d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    flat = tree_flatten_with_paths(like)
    if len(flat) != manifest["n_leaves"]:
        raise ValueError(
            f"checkpoint has {manifest['n_leaves']} leaves, model expects "
            f"{len(flat)} — was the model reconfigured (e.g. "
            f"single-head -> multi-head) since the checkpoint was saved?")
    paths = [p for p, _ in flat]
    saved_paths = manifest.get("leaf_paths")
    if check_treedef and saved_paths is not None and saved_paths != paths:
        diff = next(i for i, (a, b) in enumerate(zip(saved_paths, paths))
                    if a != b)
        raise ValueError(
            f"checkpoint tree structure differs from the model's at leaf "
            f"{diff}: ckpt {saved_paths[diff]!r}, model {paths[diff]!r} "
            f"(pass check_treedef=False to force order-based matching)")
    shard_leaves = SH.sharding_leaves(shardings) if shardings is not None \
        else [None] * len(flat)
    if len(shard_leaves) != len(flat):
        raise ValueError(f"shardings has {len(shard_leaves)} leaves, the "
                         f"tree {len(flat)}")
    out = []
    for i, (meta, (key, ref), shd) in enumerate(
            zip(manifest["leaves"], flat, shard_leaves)):
        arr = np.load(os.path.join(path, meta["file"]))
        if verify and hashlib.sha1(arr.tobytes()).hexdigest() != \
                meta["sha1"]:
            raise ValueError(f"integrity failure on leaf {i} ({key})")
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"leaf {i} ({key}): ckpt {arr.shape} vs "
                             f"model {tuple(ref.shape)}")
        if shd is None and isinstance(ref, SH.DTensor):
            shd = (ref.device_mesh, tuple(ref.placements))
        if shd is not None:
            full = torch.from_numpy(arr).to(device=shd[0].device_type,
                                            dtype=ref.dtype)
            out.append(SH.place(full, shd))
        else:
            out.append(torch.from_numpy(arr).to(device=ref.device,
                                                dtype=ref.dtype))
    return tree_unflatten(like, out), chosen, manifest["extra"]
