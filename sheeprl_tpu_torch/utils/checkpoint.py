"""Atomic checkpoints and array digests (counterpart of
sheeprl_tpu/utils/checkpoint.py).

A checkpoint is a directory ``ckpt_<policy_step>_<rank>.ckpt`` committed in
one ``os.rename`` (:func:`atomic_dir_writer`, shared with the policy
artifacts)::

    ckpt_<step>_<rank>.ckpt/
        state.pt        # the state with its numpy arrays taken out: tensors, dicts,
                        # lists, tuples, numbers and strings; read with
                        # torch.load(weights_only=True), so loading runs no pickled code
        arrays.npz      # the numpy arrays (an in-memory replay buffer), read with allow_pickle=False
        manifest.json   # step, rank, leaf count, digest, the file names; written last

A memory-mapped replay buffer is saved by reference: its state names each
file (path, dtype, shape) and the files stay where the run wrote them, so the
digest covers the reference and not the files' bytes, as the JAX package's
covers its pickled buffer and not the memmap.

The JAX package keeps its arrays in Orbax and pickles the rest; the port's
format is its own. The digest is a sha256 over every tensor and array leaf
(path, dtype, shape, bytes): :func:`load_checkpoint` recomputes it and
refuses a checkpoint whose leaves differ from what was saved. A directory
without a readable manifest, or missing a file the manifest names, is torn
and is never the latest (:func:`find_latest_valid_checkpoint`). The previous
snapshot stays until the new one is committed, and ``keep_last`` deletes the
oldest by renaming them away first.

The chaos fail points of the JAX package's save sit at the same phases:
``checkpoint.before_write`` before anything is staged,
``checkpoint.before_manifest`` after the payload and before the manifest,
and ``checkpoint.before_commit`` (``artifact.before_commit`` for a policy
artifact) between the staged payload and its rename
(:mod:`sheeprl_tpu_torch.core.chaos`). A post-save hook
(:func:`register_post_save_hook`) is called with every committed path; the
preemption guard learns of its drain save that way.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import time
import uuid
from contextlib import contextmanager
from typing import Any, Callable, Dict, Iterator, List, Mapping, Optional, Tuple

import numpy as np
import torch

from sheeprl_tpu_torch.core import chaos
from sheeprl_tpu_torch.telemetry import tracer as tracer_mod

_TMP_PREFIX = ".tmp-"
_TRASH_PREFIX = ".trash-"
_CKPT_RE = re.compile(r"ckpt_(\d+)_(\d+)\.ckpt$")
MANIFEST_NAME = "manifest.json"
STATE_NAME = "state.pt"
ARRAYS_NAME = "arrays.npz"
CHECKPOINT_SCHEMA_VERSION = 1

# Called with the committed path after every successful save.
_POST_SAVE_HOOKS: List[Callable[[str], None]] = []


def register_post_save_hook(hook: Callable[[str], None]) -> None:
    _POST_SAVE_HOOKS.append(hook)


def unregister_post_save_hook(hook: Callable[[str], None]) -> None:
    try:
        _POST_SAVE_HOOKS.remove(hook)
    except ValueError:
        pass


def flatten_arrays(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) for every tensor and numpy array of a nested structure of
    mappings (keys in sorted order), lists and tuples; other leaves (numbers,
    strings, None) are skipped."""
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return [(prefix, tree)]
    if isinstance(tree, Mapping):
        items = sorted(tree.items(), key=lambda kv: str(kv[0]))
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    else:
        return []
    leaves: List[Tuple[str, Any]] = []
    for key, value in items:
        leaves.extend(flatten_arrays(value, f"{prefix}/{key}" if prefix else str(key)))
    return leaves


def _digest_arrays(arrays: Any) -> Tuple[str, int]:
    """sha256 over every tensor and array leaf (path, dtype, shape and bytes,
    in :func:`flatten_arrays` order) and the leaf count."""
    h = hashlib.sha256()
    leaves = flatten_arrays(arrays)
    for path, leaf in leaves:
        if isinstance(leaf, torch.Tensor):
            t = leaf.detach().to("cpu").contiguous()
            dtype, data = str(t.dtype), t.reshape(-1).view(torch.uint8).numpy() if t.numel() else b""
        else:
            dtype, data = str(leaf.dtype), np.ascontiguousarray(leaf)
        h.update(path.encode())
        h.update(dtype.encode())
        h.update(str(tuple(leaf.shape)).encode())
        h.update(data)
    return h.hexdigest(), len(leaves)


def _fsync_dir(path: str) -> None:
    for root, _, files in os.walk(path):
        for name in files:
            fd = os.open(os.path.join(root, name), os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


@contextmanager
def atomic_dir_writer(final_path: str, fail_point: str = "checkpoint.before_commit") -> Iterator[str]:
    """Stage a directory payload, then commit it with one ``os.rename``.

    Yields a ``.tmp-*`` sibling of ``final_path`` (same filesystem, so the
    rename is atomic) for the caller to fill. On normal exit it is fsynced
    and renamed into place, swapping through a ``.trash-*`` sibling when
    ``final_path`` exists so the old content stays whole until the new one
    is committed. On an exception (the chaos ``fail_point`` before the
    rename among them) the staging directory is removed and ``final_path``
    is untouched."""
    final_path = os.path.abspath(final_path)
    parent = os.path.dirname(final_path)
    basename = os.path.basename(final_path)
    os.makedirs(parent, exist_ok=True)
    staging = os.path.join(parent, f"{_TMP_PREFIX}{basename}-{os.getpid()}-{uuid.uuid4().hex[:8]}")
    try:
        yield staging
        _fsync_dir(staging)
        chaos.maybe_fail(fail_point)
        if os.path.lexists(final_path):
            trash = os.path.join(parent, f"{_TRASH_PREFIX}{basename}-{uuid.uuid4().hex[:8]}")
            os.rename(final_path, trash)
            os.rename(staging, final_path)
            shutil.rmtree(trash, ignore_errors=True)
        else:
            os.rename(staging, final_path)
    except BaseException:
        shutil.rmtree(staging, ignore_errors=True)
        raise


def parse_ckpt_name(ckpt_path: str) -> Optional[Tuple[int, int]]:
    """(policy_step, rank) from a ``ckpt_<step>_<rank>.ckpt`` path, else None."""
    m = _CKPT_RE.search(os.path.basename(os.path.normpath(ckpt_path)))
    return (int(m.group(1)), int(m.group(2))) if m else None


def read_manifest(ckpt_path: str) -> Optional[Dict[str, Any]]:
    """The checkpoint's parsed ``manifest.json``; None if absent or corrupt."""
    try:
        with open(os.path.join(ckpt_path, MANIFEST_NAME), "rb") as fp:
            manifest = json.load(fp)
    except (OSError, ValueError):
        return None
    return manifest if isinstance(manifest, dict) else None


def _split_arrays(tree: Any, arrays: List[np.ndarray]) -> Any:
    """``tree`` with each numpy array moved to ``arrays`` (replaced by
    ``{"__array__": index}``) and each tensor copied to the CPU. A
    memory-mapped array raises: a buffer's state refers to its files, it
    never copies them."""
    if isinstance(tree, np.memmap):
        raise ValueError(f"a checkpoint would copy the memory-mapped array {tree.filename}; save its buffer's state_dict, which refers to it")
    if isinstance(tree, np.ndarray):
        arrays.append(tree)
        return {"__array__": len(arrays) - 1}
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, Mapping):
        return {k: _split_arrays(v, arrays) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_split_arrays(v, arrays) for v in tree)
    return tree


def _join_arrays(tree: Any, arrays: List[np.ndarray]) -> Any:
    if isinstance(tree, Mapping):
        if set(tree) == {"__array__"}:
            return arrays[int(tree["__array__"])]
        return {k: _join_arrays(v, arrays) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_join_arrays(v, arrays) for v in tree)
    return tree


def validate_checkpoint(ckpt_path: str, verify_digest: bool = False) -> bool:
    """True iff ``ckpt_path`` is a complete, committed checkpoint: the
    manifest parses, its schema is known and the files it names exist. With
    ``verify_digest`` the payload is also loaded and its leaves' digest held
    to the manifest's (:func:`load_checkpoint` always does), which catches
    bit rot and not only torn writes."""
    manifest = read_manifest(ckpt_path)
    if manifest is None or manifest.get("kind") != "checkpoint":
        return False
    try:
        if int(manifest["schema_version"]) > CHECKPOINT_SCHEMA_VERSION:
            return False
        int(manifest["step"])
        int(manifest["leaf_count"])
        files = list(manifest["files"])
    except (KeyError, TypeError, ValueError):
        return False
    if sorted(files) != sorted([STATE_NAME, ARRAYS_NAME]) or not all(os.path.isfile(os.path.join(ckpt_path, f)) for f in files):
        return False
    if not verify_digest:
        return True
    try:
        _load_verified(ckpt_path, manifest)
    except Exception:  # noqa: BLE001 - any unreadable payload means invalid
        return False
    return True


def find_latest_valid_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The checkpoint of the highest step in ``ckpt_dir`` that passes
    :func:`validate_checkpoint`, skipping torn ones; None if there is none."""
    try:
        names = os.listdir(ckpt_dir)
    except OSError:
        return None
    entries = sorted(((parse_ckpt_name(name) or (-1,))[0], name) for name in names)
    for step, name in reversed(entries):
        if step >= 0 and validate_checkpoint(os.path.join(ckpt_dir, name)):
            return os.path.join(ckpt_dir, name)
    return None


def _gc_old_checkpoints(ckpt_dir: str, keep_last: int) -> None:
    """Delete all but the newest ``keep_last`` checkpoints of ``ckpt_dir``, by
    the step in the name. Each is renamed to a ``.trash-*`` sibling first, so
    a concurrent reader sees a whole checkpoint or none."""
    entries = sorted((parsed[0], name) for name in os.listdir(ckpt_dir) if (parsed := parse_ckpt_name(name)))
    for _, name in entries[:-keep_last]:
        trash = os.path.join(ckpt_dir, f"{_TRASH_PREFIX}{name}-{uuid.uuid4().hex[:8]}")
        os.rename(os.path.join(ckpt_dir, name), trash)
        shutil.rmtree(trash, ignore_errors=True)


def save_checkpoint(ckpt_path: str, state: Dict[str, Any], keep_last: Optional[int] = None) -> str:
    """Atomically write ``state`` (a nested dict of tensors, numpy arrays and
    plain values) to ``ckpt_path`` (named ``ckpt_<step>_<rank>.ckpt``), then
    delete older checkpoints of the same directory down to ``keep_last``.
    Returns the absolute path. On the telemetry tracer: a ``checkpoint/save``
    span and the ``checkpoint_saves`` counter (the JAX package's names)."""
    start = time.perf_counter()
    ckpt_path = os.path.abspath(ckpt_path)
    parsed = parse_ckpt_name(ckpt_path)
    if parsed is None:
        raise ValueError(f"{ckpt_path}: a checkpoint is named ckpt_<step>_<rank>.ckpt")
    chaos.maybe_fail("checkpoint.before_write")
    arrays: List[np.ndarray] = []
    tree = _split_arrays(state, arrays)
    digest, leaf_count = _digest_arrays(_join_arrays(tree, arrays))
    with atomic_dir_writer(ckpt_path) as staging:
        os.makedirs(staging)
        torch.save(tree, os.path.join(staging, STATE_NAME))
        np.savez(os.path.join(staging, ARRAYS_NAME), **{f"a{i}": a for i, a in enumerate(arrays)})
        chaos.maybe_fail("checkpoint.before_manifest")
        manifest = {
            "schema_version": CHECKPOINT_SCHEMA_VERSION,
            "kind": "checkpoint",
            "step": parsed[0],
            "rank": parsed[1],
            "leaf_count": leaf_count,
            "array_count": len(arrays),
            "digest": digest,
            "files": [STATE_NAME, ARRAYS_NAME],
            "created_unix": time.time(),
        }
        with open(os.path.join(staging, MANIFEST_NAME), "w") as fp:
            json.dump(manifest, fp, indent=2)
    if keep_last is not None and keep_last > 0:
        _gc_old_checkpoints(os.path.dirname(ckpt_path), int(keep_last))
    tracer = tracer_mod.current()
    tracer.count("checkpoint_saves")
    tracer.add_span("checkpoint/save", "checkpoint", start, time.perf_counter() - start, {"step": parsed[0]})
    for hook in list(_POST_SAVE_HOOKS):
        hook(ckpt_path)
    return ckpt_path


def load_checkpoint(ckpt_path: str) -> Dict[str, Any]:
    """The saved state, tensors on the CPU and arrays as numpy. Raises
    ValueError for a torn checkpoint and for one whose leaves' digest is not
    the manifest's."""
    ckpt_path = os.path.abspath(ckpt_path)
    if not validate_checkpoint(ckpt_path):
        raise ValueError(f"{ckpt_path} is not a valid checkpoint (torn save, wrong schema or missing files)")
    return _load_verified(ckpt_path, read_manifest(ckpt_path) or {})


def _load_verified(ckpt_path: str, manifest: Dict[str, Any]) -> Dict[str, Any]:
    tree = torch.load(os.path.join(ckpt_path, STATE_NAME), map_location="cpu", weights_only=True)
    with np.load(os.path.join(ckpt_path, ARRAYS_NAME), allow_pickle=False) as npz:
        arrays = [npz[f"a{i}"] for i in range(int(manifest.get("array_count", 0)))]
    state = _join_arrays(tree, arrays)
    digest, leaf_count = _digest_arrays(state)
    if leaf_count != manifest["leaf_count"] or digest != manifest["digest"]:
        raise ValueError(f"{ckpt_path}: the loaded leaves do not match the manifest's digest")
    return state


def resume_config(cfg: Mapping[str, Any]) -> Dict[str, Any]:
    """The config of a run resumed from ``cfg.checkpoint.resume_from``: the
    saved run's ``config.json`` (two levels above the checkpoint) merged over
    ``cfg``, keeping only ``cfg``'s ``algo.total_steps``,
    ``algo.learning_starts``, ``log_root``, ``root_dir``, ``run_name``,
    ``device`` and ``resilience.chaos``, as the JAX package's
    ``resume_from_checkpoint`` does, and
    ``algo.fused_rollout``, the lane: the JAX merge keeps the saved run's,
    so its resume "on the other lane" stays on the saved run's lane
    (ROADMAP C-r11); here a checkpoint of either lane resumes on the one the
    command line names.
    ``resume_from`` may name a checkpoint or a directory of them (the newest
    valid one is taken), and becomes the checkpoint's path. Raises when
    ``env.id`` or ``algo.name`` differ from the saved run's."""
    from sheeprl_tpu_torch.utils.utils import dotdict

    path = os.path.abspath(cfg["checkpoint"]["resume_from"])
    if parse_ckpt_name(path) is None:
        latest = find_latest_valid_checkpoint(path)
        if latest is None:
            raise ValueError(f"checkpoint.resume_from={cfg['checkpoint']['resume_from']} holds no valid checkpoint")
        path = latest
    elif not validate_checkpoint(path):
        raise ValueError(f"{path} is not a valid checkpoint (torn save, wrong schema or missing files)")
    with open(os.path.join(os.path.dirname(os.path.dirname(path)), "config.json")) as fp:
        old = json.load(fp)
    for key, what in (("env", "id"), ("algo", "name")):
        if old[key][what] != cfg[key][what]:
            raise ValueError(f"The checkpoint's run has {key}.{what}={old[key][what]}, this one {cfg[key][what]}: resume with the same {key}.{what}")
    for key in ("log_root", "root_dir", "run_name", "device"):
        old.pop(key, None)
    for key in ("total_steps", "learning_starts", "fused_rollout"):
        old["algo"].pop(key, None)
    # Chaos injectors are one run's experiment: inherited, a sigterm at step
    # N would preempt the resumed run again. The command line's stay.
    (old.get("resilience") or {}).pop("chaos", None)
    old["checkpoint"]["resume_from"] = path

    def merge(dst: Dict[str, Any], src: Dict[str, Any]) -> None:
        for k, v in src.items():
            if isinstance(v, dict) and isinstance(dst.get(k), dict):
                merge(dst[k], v)
            else:
                dst[k] = v

    merged = json.loads(json.dumps(cfg))
    merge(merged, old)
    return dotdict(merged)
