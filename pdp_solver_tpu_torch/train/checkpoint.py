"""Checkpoints in the JAX package's format, with its best/last contract.

Counterpart of `pdp_solver_tpu/train/checkpoint.py` (:19-49): a tree of
numpy arrays is stored as one flat `.npz` under `<path_base>/<name>.npz`,
keyed by `jax.tree_util.keystr` of each leaf's path, written letter for
letter: a dict key as "['key']" (keys sorted, as JAX flattens dicts), a
tuple or list index as "[i]", a NamedTuple field as ".field". So a train
state written here reads in the JAX package's
`SatTrainer._load_train_state`, and one written there reads here:

    ['global_step']
    ['opt'][2].count
    ['opt'][2].mu['prop']['var_agg']['w1_m']['w']   (and .nu[...])
    ['params']['prop']['var_agg']['w1_m']['w']

`['opt']` is optax's chain of (clip by global norm, add decayed weights,
Adam, scale); only the Adam entry, index 2, has state (`OPT_STATE`).
"""

import os
from typing import NamedTuple

import numpy as np


class EmptyState(NamedTuple):
    """optax's EmptyState: a chain entry without leaves."""


class ScaleByAdamState(NamedTuple):
    """optax's ScaleByAdamState: count i32[], mu and nu trees like the
    parameters'."""
    count: np.ndarray
    mu: dict
    nu: dict


def opt_state(adam: dict):
    """The optax chain state (clip, decayed weights, Adam, scale) around
    an Adam state {"count", "mu", "nu"} (`convert.adam_to_jax`)."""
    return (EmptyState(), EmptyState(), ScaleByAdamState(**adam),
            EmptyState())


OPT_STATE = 2   # the chain entry that holds Adam's state


def _flatten(tree, prefix=""):
    """(keystr, leaf) pairs in JAX's flattening order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], f"{prefix}['{k}']")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from _flatten(getattr(tree, f), f"{prefix}.{f}")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}[{i}]")
    else:
        yield prefix, np.asarray(tree)


def _unflatten(template, leaves, prefix=""):
    if isinstance(template, dict):
        return {k: _unflatten(template[k], leaves, f"{prefix}['{k}']")
                for k in template}
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(
            _unflatten(getattr(template, f), leaves, f"{prefix}.{f}")
            for f in template._fields))
    if isinstance(template, (tuple, list)):
        return type(template)(_unflatten(v, leaves, f"{prefix}[{i}]")
                              for i, v in enumerate(template))
    return leaves[prefix]


def _file(path_base, name):
    return os.path.join(path_base, name + ".npz")


def save_params(path_base, tree, name):
    os.makedirs(path_base, exist_ok=True)
    np.savez(_file(path_base, name), **dict(_flatten(tree)))


def checkpoint_keys(path_base, name):
    """The flat keys stored in a checkpoint (a params-only checkpoint, the
    layout before round 5, has no "['opt']" keys)."""
    with np.load(_file(path_base, name)) as data:
        return list(data.files)


def load_params(path_base, template, name):
    """Restore into the structure of `template` (a tree of numpy arrays;
    every leaf must be stored, with its shape), cast to the template's
    dtypes."""
    fname = _file(path_base, name)
    leaves = {}
    with np.load(fname) as data:
        for key, leaf in _flatten(template):
            if key not in data:
                raise KeyError(f"checkpoint {fname} missing leaf {key}")
            arr = data[key]
            if arr.shape != leaf.shape:
                raise ValueError(f"checkpoint leaf {key} shape {arr.shape} "
                                 f"!= {leaf.shape}")
            leaves[key] = arr.astype(leaf.dtype)
    return _unflatten(template, leaves)
