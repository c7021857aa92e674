"""Checkpoint / resume of progressive render state and of training state.

The formats of ``haskell_path_tracer_tpu/utils/checkpoint.py``, each one
.npz written by atomic rename, so a checkpoint written by either package
loads in the other:

  * the accumulator: keys version, color, rng (uint32 on disk) and
    iterations, plus extra_* arrays;
  * the training state: ``leaf_i`` for the leaves of (params, opt_state)
    in JAX's flattening order (a NamedTuple's fields in order, a dict's
    keys sorted, lists and tuples in order, None no leaf; tensors, arrays
    and Python numbers are leaves), ``step`` int64 and ``version`` int32.
"""

from __future__ import annotations

import collections
import json
import os
import tempfile

import numpy as np
import torch

from ..models.convert import accumulator_from_numpy, accumulator_to_numpy
from ..models.objects import Accumulator

FORMAT_VERSION = 1


def _atomic_savez(path: str, arrays: dict) -> None:
    """Write `arrays` to `path` through a temporary file in its directory
    and an atomic rename: a reader never sees a torn file."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def save_accumulator(path: str, acc: Accumulator, extra: dict | None = None) -> None:
    """Atomically write the accumulator (+ optional extra arrays)."""
    arrays = {"version": np.int32(FORMAT_VERSION), **accumulator_to_numpy(acc)}
    for k, v in (extra or {}).items():
        arrays["extra_" + k] = np.asarray(v)
    _atomic_savez(path, arrays)


def load_accumulator(path: str, device):
    """Returns (Accumulator on `device`, extra dict)."""
    with np.load(path) as z:
        version = int(z["version"])
        if version != FORMAT_VERSION:
            raise ValueError(f"checkpoint format {version}, expected {FORMAT_VERSION}")
        acc = accumulator_from_numpy(z, device)
        extra = {
            k[len("extra_"):]: z[k] for k in z.files if k.startswith("extra_")
        }
    return acc, extra


def _flatten(tree, leaves: list | None):
    """Append `tree`'s leaves to `leaves` (unless None) in JAX's order and
    return its structure as JSON-able data."""
    if isinstance(tree, torch.Tensor):
        if leaves is not None:
            leaves.append(tree.detach().cpu().numpy())
        return {"leaf": "tensor"}
    if isinstance(tree, (np.ndarray, np.generic, bool, int, float)):
        if leaves is not None:
            leaves.append(np.asarray(tree))
        kind = "array" if isinstance(tree, (np.ndarray, np.generic)) else type(tree).__name__
        return {"leaf": kind}
    if tree is None:
        return {"none": True}
    if isinstance(tree, str):
        return {"str": tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {"namedtuple": type(tree).__name__, "fields": list(tree._fields),
                "items": [_flatten(v, leaves) for v in tree]}
    if isinstance(tree, (list, tuple)):
        return {type(tree).__name__: [_flatten(v, leaves) for v in tree]}
    if isinstance(tree, dict):
        keys = sorted(tree)
        return {"keys": keys, "items": [_flatten(tree[k], leaves) for k in keys]}
    raise TypeError(f"cannot checkpoint a {type(tree).__name__}")


def _leaf_value(kind: str, leaf: np.ndarray, device):
    if kind == "tensor":
        return torch.as_tensor(np.array(leaf), device=device)
    if kind == "array":
        return leaf
    return {"bool": bool, "int": int, "float": float}[kind](leaf.item())


def _unflatten(spec, leaves, device):
    """Rebuild a tree from `_flatten`'s structure, taking its leaves from
    the iterator `leaves`."""
    if "leaf" in spec:
        return _leaf_value(spec["leaf"], next(leaves), device)
    if "none" in spec:
        return None
    if "str" in spec:
        return spec["str"]
    if "namedtuple" in spec:
        cls = collections.namedtuple(spec["namedtuple"], spec["fields"])
        return cls(*(_unflatten(s, leaves, device) for s in spec["items"]))
    if "list" in spec:
        return [_unflatten(s, leaves, device) for s in spec["list"]]
    if "tuple" in spec:
        return tuple(_unflatten(s, leaves, device) for s in spec["tuple"])
    return {k: _unflatten(s, leaves, device) for k, s in zip(spec["keys"], spec["items"])}


def _like(template, leaves, device):
    """Rebuild a tree of `template`'s structure from the iterator `leaves`:
    a tensor leaf becomes a tensor on `device` (the template's device when
    None), a Python number the template's type."""
    spec = _flatten(template, None)

    def rebuild(t, s):
        if "leaf" in s:
            kind = s["leaf"]
            dev = device if device is not None or kind != "tensor" else t.device
            return _leaf_value(kind, next(leaves), dev)
        if "namedtuple" in s:
            return type(t)(*(rebuild(v, c) for v, c in zip(t, s["items"])))
        if "list" in s or "tuple" in s:
            return type(t)(rebuild(v, c) for v, c in zip(t, s.get("list", s.get("tuple"))))
        if "keys" in s:
            return {k: rebuild(t[k], c) for k, c in zip(s["keys"], s["items"])}
        return t

    return rebuild(template, spec)


def save_training_state(path: str, params, opt_state, step: int) -> None:
    """Atomically checkpoint an inverse-rendering run: `params` (SceneParams)
    and `opt_state`, any tree of tensors, arrays, numbers, strings and None
    in dicts, lists, tuples and NamedTuples; a `torch.optim` optimizer's
    `state_dict()` is such a tree.

    Leaves are `leaf_i` in JAX's order, as the JAX package writes them, so
    its `load_training_state` reads the file back for the same structure.
    What is not an array is stored beside them, in a JSON string under
    ``structure``: the tree's shape (dict keys with their types, so a
    state_dict's integer parameter ids stay integers; tuples apart from
    lists), the type of every leaf (tensor, array, or the Python int,
    float or bool it was) and the strings and Nones, which have no leaf.
    Python numbers are leaves, 0-d arrays, as in JAX."""
    leaves: list = []
    spec = _flatten((params, opt_state), leaves)
    arrays = {f"leaf_{i}": l for i, l in enumerate(leaves)}
    arrays["step"] = np.int64(step)
    arrays["version"] = np.int32(FORMAT_VERSION)
    arrays["structure"] = np.array(json.dumps(spec))
    _atomic_savez(path, arrays)


def load_training_state(path: str, params_like, opt_state_like=None, device=None):
    """Restore (params, opt_state, step).

    `params_like` (and `opt_state_like` where given) give the structure, as
    the JAX package's loader takes them: tensors come back on `device`, or
    each on its template's device when `device` is None.  Without
    `opt_state_like` the optimizer state is rebuilt from the structure
    this package stored (a JAX-written file has none): its tensors on
    `device` (the CPU when None), its numbers, strings and Nones as they
    were, so `optimizer.load_state_dict(opt_state)` resumes an optimizer."""
    with np.load(path) as z:
        version = int(z["version"])
        if version != FORMAT_VERSION:
            raise ValueError(f"checkpoint format {version}, expected {FORMAT_VERSION}")
        n = len([k for k in z.files if k.startswith("leaf_")])
        leaves = iter([z[f"leaf_{i}"] for i in range(n)])
        step = int(z["step"])
        spec = json.loads(str(z["structure"])) if "structure" in z.files else None
    params = _like(params_like, leaves, device)
    if opt_state_like is not None:
        opt_state = _like(opt_state_like, leaves, device)
    elif spec is not None:
        opt_state = _unflatten(spec["tuple"][1], leaves, device or "cpu")
    else:
        raise ValueError(f"{path} stores no structure: pass opt_state_like")
    if next(leaves, None) is not None:
        raise ValueError(f"{path} holds more leaves than the structure takes")
    return params, opt_state, step
