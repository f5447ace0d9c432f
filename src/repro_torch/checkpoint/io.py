"""Parameter trees to ``.npz`` and back, in the archive format of the JAX
package's ``repro.checkpoint.io`` (format version 4), so that either
package reads what the other wrote.

An archive holds one array per leaf, keyed by the "/"-joined dict keys of
its path (keys sorted at every level, the order ``jax.tree_util``
flattens a dict in), and ``__meta__``: a JSON object with the caller's
metadata, ``__ckpt_format__`` = 4 and ``__crc__``, the ``zlib.crc32`` of
each array's C-order bytes. ``save_pytree`` is atomic: a temp file in the
target directory, fsync, then ``os.replace``. ``load_pytree`` checks the
format version first (3 and 4 are read; a v3 archive has no checksums)
and each array's checksum. Trainer state and resume are not ported
(``ROADMAP.md``).
"""
from __future__ import annotations

import json
import os
import zipfile
import zlib

import numpy as np
import torch

from repro_torch import resolve_device

CKPT_FORMAT_VERSION = 4
_MIN_READ_VERSION = 3
_FORMAT_KEY = "__ckpt_format__"
_CRC_KEY = "__crc__"
_META_KEY = "__meta__"


class CheckpointFormatError(ValueError):
    """Archive was written by an incompatible checkpoint format version."""


class CheckpointCorruptError(ValueError):
    """Archive failed an integrity check: a stored array's CRC32 does not
    match the one recorded at save time, or the zip container is
    damaged."""


def _check_format(path: str, meta: dict):
    version = int(meta.get(_FORMAT_KEY, 1))
    if not _MIN_READ_VERSION <= version <= CKPT_FORMAT_VERSION:
        raise CheckpointFormatError(
            f"{path}: checkpoint format version {version}, expected "
            f"{CKPT_FORMAT_VERSION} (>= {_MIN_READ_VERSION} accepted)")


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes())


def _flatten(tree, prefix: str = "") -> dict:
    """{"a/b": leaf as numpy} in sorted-key order, nested dicts joined."""
    if isinstance(tree, dict):
        flat = {}
        for k in sorted(tree):
            flat.update(_flatten(tree[k], f"{prefix}{k}/"))
        return flat
    if isinstance(tree, torch.Tensor):
        tree = tree.detach().cpu().numpy()
    return {prefix[:-1]: np.asarray(tree)}


def _load_npz(path: str):
    try:
        return np.load(path, allow_pickle=False)
    except (zipfile.BadZipFile, EOFError) as e:
        raise CheckpointCorruptError(
            f"{path}: archive container is damaged ({e})") from e


def _read_meta(path: str, data) -> dict:
    if _META_KEY not in data.files:
        raise CheckpointFormatError(f"{path}: no {_META_KEY} entry; not a "
                                    "checkpoint archive")
    meta = json.loads(str(data[_META_KEY]))
    _check_format(path, meta)
    return meta


def save_pytree(path: str, params: dict, metadata: dict | None = None):
    """Atomically write ``params`` (nested ``dict[str, Tensor | ndarray]``)
    and the JSON-able ``metadata`` to exactly ``path``."""
    flat = _flatten(params)
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    meta = dict(metadata or {})
    meta[_FORMAT_KEY] = CKPT_FORMAT_VERSION
    meta[_CRC_KEY] = {k: _crc(v) for k, v in flat.items()}
    tmp = f"{path}.tmp-{os.getpid()}"
    try:
        # through a file handle, np.savez appends no ".npz" to the name
        with open(tmp, "wb") as f:
            np.savez(f, **{_META_KEY: json.dumps(meta)}, **flat)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load_pytree(path: str, device="cuda") -> dict:
    """The archive's arrays as a nested dict of tensors on ``device`` (the
    "/"-joined keys split back into levels), each verified against its
    checksum. ``cuda`` unless the caller asks for the CPU: asking for it
    without a card raises (``repro_torch.resolve_device``)."""
    device = resolve_device(device)
    data = _load_npz(path)
    crcs = _read_meta(path, data).get(_CRC_KEY)
    tree: dict = {}
    for key in data.files:
        if key == _META_KEY:
            continue
        try:
            arr = data[key]
        except (zipfile.BadZipFile, EOFError, zlib.error) as e:
            raise CheckpointCorruptError(
                f"{path}: stored array {key!r} is unreadable ({e})") from e
        stored = None if crcs is None else crcs.get(key)
        if stored is not None and _crc(arr) != int(stored):
            raise CheckpointCorruptError(
                f"{path}: stored array {key!r} failed its CRC32 check")
        *parents, leaf = key.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = torch.as_tensor(arr).to(device)
    return tree


def load_metadata(path: str) -> dict:
    """The caller's metadata of the archive (format key and checksums
    removed); raises ``CheckpointFormatError`` on another version."""
    meta = _read_meta(path, _load_npz(path))
    meta.pop(_FORMAT_KEY, None)
    meta.pop(_CRC_KEY, None)
    return meta
