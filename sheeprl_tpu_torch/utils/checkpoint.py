"""Atomic directory commits and array digests (the part of
sheeprl_tpu/utils/checkpoint.py the policy artifacts need)."""

from __future__ import annotations

import hashlib
import os
import shutil
import uuid
from contextlib import contextmanager
from typing import Any, Iterator, List, Mapping, Tuple

import torch

_TMP_PREFIX = ".tmp-"
_TRASH_PREFIX = ".trash-"


def flatten_tensors(tree: Any, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """(path, tensor) leaves of a nested mapping, in sorted key order."""
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    if not isinstance(tree, Mapping):
        raise TypeError(f"{prefix or '<root>'}: expected a tensor or a mapping, got {type(tree).__name__}")
    leaves: List[Tuple[str, torch.Tensor]] = []
    for key in sorted(tree):
        leaves.extend(flatten_tensors(tree[key], f"{prefix}/{key}" if prefix else str(key)))
    return leaves


def _digest_arrays(arrays: Any) -> Tuple[str, int]:
    """sha256 over every tensor leaf (path, dtype, shape and bytes, in sorted
    key order) and the leaf count."""
    h = hashlib.sha256()
    leaves = flatten_tensors(arrays)
    for path, leaf in leaves:
        t = leaf.detach().to("cpu").contiguous()
        h.update(path.encode())
        h.update(str(t.dtype).encode())
        h.update(str(tuple(t.shape)).encode())
        h.update(t.view(torch.uint8).numpy().tobytes() if t.numel() else b"")
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
def atomic_dir_writer(final_path: str) -> Iterator[str]:
    """Stage a directory payload, then commit it with one ``os.rename``.

    Yields a ``.tmp-*`` sibling of ``final_path`` (same filesystem, so the
    rename is atomic) for the caller to fill. On normal exit it is fsynced
    and renamed into place, swapping through a ``.trash-*`` sibling when
    ``final_path`` exists so the old content stays whole until the new one
    is committed. On an exception the staging directory is removed and
    ``final_path`` is untouched."""
    final_path = os.path.abspath(final_path)
    parent = os.path.dirname(final_path)
    basename = os.path.basename(final_path)
    os.makedirs(parent, exist_ok=True)
    staging = os.path.join(parent, f"{_TMP_PREFIX}{basename}-{os.getpid()}-{uuid.uuid4().hex[:8]}")
    try:
        yield staging
        _fsync_dir(staging)
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
