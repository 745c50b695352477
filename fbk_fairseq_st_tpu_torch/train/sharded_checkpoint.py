"""JAX's sharded checkpoint layout, read and written without JAX, and the
asynchronous writer (``--checkpoint-format sharded``, ``--async-checkpoint``).

The port's counterpart of ``fbk_fairseq_st_tpu/train/sharded_checkpoint.py``
(``save_sharded`` :66, ``load_sharded`` :287, ``AsyncCheckpointWriter``
:327). A checkpoint is a directory under the usual file name:

    <name>.pt/
      meta.pkl                          {"meta": what is not an array,
                                         "trees": {key: {"treedef", "leaves"}}}
      arrays/<key>.<leaf>.<shard>.npy   one file a distinct shard of a leaf

where each leaf's manifest entry holds its path ("/"-joined keys; a
NamedTuple's field as ".name"), shape, dtype and shards ({"index": the
(start, stop) of each axis, "file"}).

Reading (``load_sharded``) takes the manifest through the reader's
``_SafeUnpickler`` (JAX's ``PyTreeDef`` becomes an unread stub), checks
that each leaf's shards have the shapes their indices say and tile it
exactly (a hole raises ``ValueError``), and rebuilds each tree from the
leaf paths: nested dicts, a run of numeric keys a list (a gap None), a
run of ".field" keys a namedtuple with those fields (what
``utils.weights.optimizer_state_from_jax`` reads of an optax state).

Writing (``save_sharded``) writes the port's own state in that layout, one
shard a leaf (one process): the trees ``model`` (the state dict, flat,
keys sorted) and ``opt_state`` ({"state": {parameter index: {name:
tensor}}}), everything else in ``meta`` (``last_optimizer_param_names``
marks the port's layout). So that JAX's ``load_sharded`` can unflatten
them too, each tree's ``treedef`` is written as the pickle of a
``PyTreeDef`` of nested dicts (``_PyTreeDefPickler``: jaxlib's node list,
read by reference to ``jaxlib._jax.pytree.PyTreeDef``, the module of the
JAX this repo was written against). Files go to ``<name>.pt.tmp`` and are
renamed into place; further names are copies made the same way.

``AsyncCheckpointWriter.save`` copies the arrays into host memory on the
caller's thread and writes them on a background thread; the next save,
``wait`` and the end of training wait for it, and an error in the writer
is raised there.
"""

from __future__ import annotations

import collections
import io
import logging
import os
import pickle
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

logger = logging.getLogger(__name__)

_MANIFEST = "meta.pkl"
_ARRAYS = "arrays"


def is_sharded_checkpoint(path: str) -> bool:
    return os.path.isdir(path) and os.path.exists(os.path.join(path, _MANIFEST))


def clear_path(path: str) -> None:
    """Remove a checkpoint file or directory."""
    if os.path.isdir(path):
        shutil.rmtree(path)
    elif os.path.lexists(path):
        os.remove(path)


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------

def load_sharded(path: str, unpickler) -> Dict[str, Any]:
    """The checkpoint's meta entries and its trees of numpy arrays."""
    with open(os.path.join(path, _MANIFEST), "rb") as f:
        manifest = unpickler(f).load()
    out = dict(manifest["meta"])
    for key, info in manifest["trees"].items():
        if info is None:
            out[key] = None
            continue
        leaves = [(entry["path"], _assemble(path, entry)) for entry in info["leaves"]]
        out[key] = tree_from_paths(leaves)
    return out


def _assemble(path: str, entry: Dict[str, Any]) -> np.ndarray:
    shape = tuple(entry["shape"])
    arr = np.empty(shape, np.dtype(entry["dtype"]))
    covered = 0
    for shard in entry["shards"]:
        data = np.load(os.path.join(path, _ARRAYS, shard["file"]))
        extent = tuple(b - a for a, b in shard["index"])
        if data.shape != extent:
            raise ValueError(f"sharded checkpoint leaf {entry['path']!r}: shard {shard['file']} holds "
                             f"{data.shape}, its index says {extent}")
        if arr.ndim == 0:
            arr = data.reshape(())
        else:
            arr[tuple(slice(a, b) for a, b in shard["index"])] = data
        covered += int(np.prod(extent)) if extent else 1
    # rectangular shards: their volumes must tile the leaf exactly
    if covered != arr.size:
        raise ValueError(f"sharded checkpoint leaf {entry['path']!r} is incomplete: shards cover {covered} "
                         f"of {arr.size} elements")
    return arr


def tree_from_paths(leaves: List[Tuple[str, Any]]) -> Any:
    """Nested containers from ("a/0/.mu/b", leaf) pairs: dicts, lists
    where every key is a number, namedtuples where every key is ".field"."""
    root: Dict[str, Any] = {}
    for leaf_path, leaf in leaves:
        parts = leaf_path.split("/") if leaf_path else []
        if not parts:
            return leaf
        node = root
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = leaf
    return _containers(root)


def _containers(node: Any) -> Any:
    if not isinstance(node, dict):
        return node
    items = {k: _containers(v) for k, v in node.items()}
    if items and all(k.startswith(".") for k in items):
        fields = [k[1:] for k in items]
        return collections.namedtuple("State", fields)(*items.values())
    if items and all(k.isdigit() for k in items):
        out = [None] * (max(int(k) for k in items) + 1)
        for k, v in items.items():
            out[int(k)] = v
        return out
    return items


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------

def _host_copy(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy().copy()
    return np.array(value, copy=True)


def _flatten(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) pairs of nested dicts, keys sorted as JAX flattens them."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten(tree[k], f"{prefix}/{k}" if prefix else str(k))
        return out
    return [(prefix, tree)]


def _treedef_nodes(tree: Any) -> List[tuple]:
    """jaxlib's post-order node list of nested dicts: (kind, arity,
    node data, custom, leaves, nodes); kind 0 a leaf, 5 a dict."""
    if not isinstance(tree, dict):
        return [(0, 0, None, None, 1, 1)]
    nodes, n_leaves = [], 0
    keys = sorted(tree)
    for k in keys:
        sub = _treedef_nodes(tree[k])
        nodes += sub
        n_leaves += sub[-1][4]
    return nodes + [(5, len(keys), keys, None, n_leaves, len(nodes) + 1)]


class _TreeDef:
    def __init__(self, nodes):
        self.nodes = nodes


class _PyTreeDefPickler(pickle._Pickler):
    """Pickles a ``_TreeDef`` as JAX pickles a ``PyTreeDef`` (``NEWOBJ`` of
    the class, then ``BUILD`` with the state (default registry, node
    list)), naming jaxlib's globals without importing them."""

    _CLASS = ("jaxlib._jax.pytree", "PyTreeDef")
    _REGISTRY = ("jax._src.tree_util", "default_registry")

    def _global(self, module: str, name: str) -> None:
        self.save(module)
        self.save(name)
        self.write(pickle.STACK_GLOBAL)

    def save(self, obj, save_persistent_id=True):
        if isinstance(obj, _TreeDef):
            self._global(*self._CLASS)
            self.save(())
            self.write(pickle.NEWOBJ)
            self.write(pickle.MARK)
            self._global(*self._REGISTRY)
            self.save(obj.nodes)
            self.write(pickle.TUPLE)
            self.write(pickle.BUILD)
            return
        super().save(obj, save_persistent_id)


def snapshot(state: Dict[str, Any], array_keys=("model", "model_state", "opt_state")) -> Dict[str, Any]:
    """The manifest and the host copies of every leaf of ``state``'s
    ``array_keys`` trees (nested dicts of tensors or arrays), one shard a
    leaf; the other entries go into ``meta``."""
    manifest = {"meta": {k: v for k, v in state.items() if k not in array_keys}, "trees": {}}
    payload = []
    for key in array_keys:
        tree = state.get(key)
        if tree is None:
            manifest["trees"][key] = None
            continue
        leaves = []
        for leaf_id, (leaf_path, leaf) in enumerate(_flatten(tree)):
            arr = _host_copy(leaf)
            fname = f"{key}.{leaf_id}.0.npy"
            leaves.append({"path": leaf_path, "shape": tuple(arr.shape), "dtype": str(arr.dtype),
                           "shards": [{"index": tuple((0, d) for d in arr.shape), "file": fname}]})
            payload.append((fname, arr))
        manifest["trees"][key] = {"treedef": _TreeDef(_treedef_nodes(tree)), "leaves": leaves}
    return {"manifest": manifest, "shards": payload}


def write_snapshot(paths: List[str], snap: Dict[str, Any]) -> None:
    """``paths[0]`` through ``<path>.tmp`` and a rename, then each further
    name as a copy made the same way."""
    path = paths[0]
    tmp = path + ".tmp"
    clear_path(tmp)
    os.makedirs(os.path.join(tmp, _ARRAYS))
    for fname, arr in snap["shards"]:
        np.save(os.path.join(tmp, _ARRAYS, fname), arr)
    buf = io.BytesIO()
    _PyTreeDefPickler(buf, protocol=pickle.HIGHEST_PROTOCOL).dump(snap["manifest"])
    with open(os.path.join(tmp, _MANIFEST), "wb") as f:
        f.write(buf.getvalue())
    clear_path(path)
    os.replace(tmp, path)
    for extra in paths[1:]:
        clear_path(extra + ".tmp")
        shutil.copytree(path, extra + ".tmp")
        clear_path(extra)
        os.replace(extra + ".tmp", extra)


def save_sharded(paths, state: Dict[str, Any]) -> None:
    write_snapshot([paths] if isinstance(paths, str) else list(paths), snapshot(state))


class AsyncCheckpointWriter:
    """One write in flight: ``save`` waits for the previous one, copies the
    arrays to host memory, and writes them on a background thread."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, paths, state: Dict[str, Any], on_complete=None) -> None:
        paths = [paths] if isinstance(paths, str) else list(paths)
        self.wait()
        snap = snapshot(state)

        def run():
            try:
                write_snapshot(paths, snap)
                logger.info("async checkpoint written: %s", ", ".join(paths))
                if on_complete is not None:
                    on_complete()
            except BaseException as e:  # raised at the next wait()
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()
