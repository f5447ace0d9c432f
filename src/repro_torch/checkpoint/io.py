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
and each array's checksum. Given a ``template`` it is strict, as the
reference's: the key set, every shape and every dtype must match.

The trainers' round checkpoints (``fed/engine.py``) are built on these:
``checkpoint_path`` / ``latest_checkpoint`` name and find the per-round
``ckpt_<t>.npz`` archives, ``prune_checkpoints`` keeps the newest few, and
``saved_array_specs`` gives the template of state whose size is known only
at save time (lazy state-table rows, arrival queues).
"""
from __future__ import annotations

import json
import os
import re
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
_CKPT_RE = re.compile(r"ckpt_(\d+)\.npz$")


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


def _flatten_leaves(tree, prefix: str = "") -> dict:
    """{"a/b": leaf} in sorted-key order, nested dicts joined; a list's
    items are keyed by their index ("blocks_list/0/ln/scale"), as the
    reference's ``_path_str`` keys a sequence."""
    if isinstance(tree, dict):
        flat = {}
        for k in sorted(tree):
            flat.update(_flatten_leaves(tree[k], f"{prefix}{k}/"))
        return flat
    if isinstance(tree, list):
        flat = {}
        for i, v in enumerate(tree):
            flat.update(_flatten_leaves(v, f"{prefix}{i}/"))
        return flat
    return {prefix[:-1]: tree}


def _flatten(tree) -> dict:
    """{"a/b": leaf as numpy} in sorted-key order, nested dicts joined."""
    return {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v))
            for k, v in _flatten_leaves(tree).items()}


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
    """Atomically write ``params`` (nested ``dict[str, Tensor | ndarray]``,
    lists among them) and the JSON-able ``metadata`` to exactly ``path``."""
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


def _read_array(path: str, data, crcs, key: str) -> np.ndarray:
    """One stored array, verified against its save-time checksum."""
    try:
        arr = data[key]
    except (zipfile.BadZipFile, EOFError, zlib.error) as e:
        raise CheckpointCorruptError(
            f"{path}: stored array {key!r} is unreadable ({e})") from e
    stored = None if crcs is None else crcs.get(key)
    if stored is not None and _crc(arr) != int(stored):
        raise CheckpointCorruptError(
            f"{path}: stored array {key!r} failed its CRC32 check")
    return arr


def _unflatten_into(template, prefix: str, flat: dict):
    if isinstance(template, dict):
        return {k: _unflatten_into(v, f"{prefix}{k}/", flat)
                for k, v in template.items()}
    if isinstance(template, list):
        return [_unflatten_into(v, f"{prefix}{i}/", flat)
                for i, v in enumerate(template)]
    return flat[prefix[:-1]]


def load_pytree(path: str, template: dict | None = None, device="cuda"):
    """The archive's arrays, each verified against its checksum.

    Without ``template``: a nested dict of tensors on ``device`` (the
    "/"-joined keys split back into levels); ``cuda`` unless the caller
    asks for the CPU, and asking for it without a card raises
    (``repro_torch.resolve_device``).

    With ``template`` (a nested dict, lists among them, of tensors and
    numpy arrays): strict.
    The archive's keys must be the template's flattened keys exactly, and
    each array's shape and dtype its leaf's, else ``ValueError``. A numpy
    leaf comes back as host numpy; a tensor leaf lands on that tensor's
    device (``device`` is not used)."""
    data = _load_npz(path)
    crcs = _read_meta(path, data).get(_CRC_KEY)
    file_keys = set(data.files) - {_META_KEY}
    if template is None:
        device = resolve_device(device)
        tree: dict = {}
        for key in data.files:
            if key == _META_KEY:
                continue
            arr = _read_array(path, data, crcs, key)
            *parents, leaf = key.split("/")
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = torch.as_tensor(arr).to(device)
        return tree
    leaves = _flatten_leaves(template)
    missing = sorted(set(leaves) - file_keys)
    extra = sorted(file_keys - set(leaves))
    if missing or extra:
        raise ValueError(
            f"checkpoint {path} does not match the template: missing keys "
            f"{missing or 'none'}, extra keys {extra or 'none'}")
    flat = {}
    for key, tmpl in leaves.items():
        arr = _read_array(path, data, crcs, key)
        shape = tuple(tmpl.shape)
        if arr.shape != shape:
            raise ValueError(f"shape mismatch at {key}: {arr.shape} vs "
                             f"{shape}")
        if isinstance(tmpl, torch.Tensor):
            got = torch.as_tensor(arr)
            if got.dtype != tmpl.dtype:
                raise ValueError(f"dtype mismatch at {key}: {arr.dtype} vs "
                                 f"{tmpl.dtype}")
            flat[key] = got.to(tmpl.device)
        else:
            if arr.dtype != np.asarray(tmpl).dtype:
                raise ValueError(f"dtype mismatch at {key}: {arr.dtype} vs "
                                 f"{np.asarray(tmpl).dtype}")
            flat[key] = np.array(arr)
    return _unflatten_into(template, "", flat)


def load_metadata(path: str) -> dict:
    """The caller's metadata of the archive (format key and checksums
    removed); raises ``CheckpointFormatError`` on another version."""
    meta = _read_meta(path, _load_npz(path))
    meta.pop(_FORMAT_KEY, None)
    meta.pop(_CRC_KEY, None)
    return meta


def saved_array_specs(path: str) -> dict:
    """``{key: (shape, dtype)}`` of every stored array: the template of
    state whose size is only known at save time."""
    data = _load_npz(path)
    return {k: (data[k].shape, data[k].dtype)
            for k in data.files if k != _META_KEY}


def checkpoint_path(directory: str, t: int) -> str:
    """The round-``t`` checkpoint's name in ``directory``."""
    return os.path.join(directory, f"ckpt_{t:08d}.npz")


def prune_checkpoints(directory: str, keep: int) -> list:
    """Delete all but the newest ``keep`` ``ckpt_<t>.npz`` archives of
    ``directory`` (by round number) and return the removed paths. Run after
    a successful atomic write, so the newest archive always survives;
    other files are left alone, and ``keep <= 0`` keeps everything."""
    if keep <= 0:
        return []
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    found = sorted((int(m.group(1)), name) for name in names
                   if (m := _CKPT_RE.fullmatch(name)))
    removed = []
    for _, name in found[:-keep]:
        path = os.path.join(directory, name)
        try:
            os.remove(path)
            removed.append(path)
        except OSError:
            pass                # already gone: nothing to keep
    return removed


def latest_checkpoint(directory: str) -> str | None:
    """The highest-round ``ckpt_*.npz`` of ``directory``; None for a
    missing directory or one without checkpoints."""
    try:
        names = os.listdir(directory)
    except OSError:
        return None
    found = [(int(m.group(1)), name) for name in names
             if (m := _CKPT_RE.fullmatch(name))]
    return os.path.join(directory, max(found)[1]) if found else None
