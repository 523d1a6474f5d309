"""Checkpoints in ``mmvae_tpu``'s npz layout, with the Adam state.

Port of ``mmvae_tpu/train/checkpoint.py``, numpy only.  A checkpoint is
``<dir>/ckpt.npz`` holding ``params/<name>/<leaf>`` arrays, the optimizer
state, and a ``__meta__`` JSON record (``epoch``, ``seed``, ``loss_vec``,
``opt_treedef``, ``n_opt_leaves``), plus a ``meta.json`` sidecar.

The optimizer state is the JAX trainer's optax chain ``(clip, wd, adam,
scale)``, of which only element 2, ``ScaleByAdamState(count, mu, nu)``,
holds leaves.  It is stored in the named (unpacked) tree under the keys
``jax.tree_util.keystr`` gives that chain: ``opt/[2].count``,
``opt/[2].mu['mu_decoding']['weight']``, ..., ``opt/[2].nu[...]``, with
``n_opt_leaves = 1 + 2 * (number of params)``.  So
``mmvae_tpu.train.checkpoint.load_checkpoint`` with an optimizer template
resumes a checkpoint written here, and :func:`load_opt_state` reads one
written by the JAX trainer.  Params-only checkpoints (``opt_state=None``)
keep ``n_opt_leaves = 0``.

A tensor-parallel run's chain has no clip (``make_optimizer(tp=True)``:
``(wd, adam, scale)``), so its checkpoint holds Adam at element 1:
``opt/[1].count``, ``opt/[1].mu[...]``, ``opt/[1].nu[...]``, with that
chain's treedef (``save_checkpoint(tp=True)``, the layout JAX's TP
trainer writes).  The arrays are the full ones: the trainer gathers the
split leaves over the model row before rank 0 writes.  Each layout loads
only where it was asked for (``load_opt_state(tp=...)``), as in JAX; the
parameters load from either.
"""

from __future__ import annotations

import json
import os
import tempfile

import numpy as np
import torch

from ..models.nb import params_to_numpy
from ..parallel.multihost import host_role


def _flatten(tree: dict, prefix: str = "") -> dict:
    flat = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            flat.update(_flatten(v, f"{prefix}{k}/"))
        else:
            flat[f"{prefix}{k}"] = v
    return flat


def _atomic_write(path: str, write) -> None:
    d = os.path.dirname(path)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp" + os.path.splitext(
        path)[1])
    os.close(fd)
    try:
        write(tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _keystr(key: str) -> str:
    """``jax.tree_util.keystr`` of a ``/``-joined dict path."""
    return "".join(f"['{p}']" for p in key.split("/"))


def _read_tree(data, template: dict, name) -> dict:
    """The arrays ``data[name(key)]`` for every leaf of ``template``, as
    a tree of the same shape; a missing key or a shape mismatch raises."""
    tree: dict = {}
    for key, leaf in _flatten(template).items():
        arr = data[name(key)]
        if arr.shape != tuple(leaf.shape):
            raise ValueError(f"checkpoint shape mismatch for {name(key)}: "
                             f"{arr.shape} vs {tuple(leaf.shape)}")
        node = tree
        *parents, last = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = arr
    return tree


def _treedef(tree: dict) -> str:
    """The JAX treedef text of a nested dict (keys sorted, as JAX
    flattens them)."""
    return "{" + ", ".join(
        f"'{k}': " + (_treedef(tree[k]) if isinstance(tree[k], dict)
                      else "*") for k in sorted(tree)) + "}"


_EMPTY = "CustomNode(namedtuple[EmptyState], [])"


def _adam_index(tp: bool) -> int:
    """Adam's element of the chain: 2 behind the clip, 1 without it."""
    return 1 if tp else 2


def _opt_entries(opt_state: dict, tp: bool = False) -> tuple[dict, str]:
    """npz entries and treedef text of a named Adam state ``{count, mu,
    nu}`` (tensors or numpy), in the trainer's chain or, with ``tp``, the
    tensor-parallel one."""
    count, mu, nu = (params_to_numpy(opt_state[k]) for k in ("count", "mu", "nu"))
    i = _adam_index(tp)
    flat = {f"opt/[{i}].count": np.asarray(count, np.int32)}
    for m, tree in (("mu", mu), ("nu", nu)):
        flat.update({f"opt/[{i}].{m}{_keystr(k)}": v
                     for k, v in _flatten(tree).items()})
    t = _treedef(mu)
    adam = f"CustomNode(namedtuple[ScaleByAdamState], [*, {t}, {t}])"
    head = "" if tp else f"{_EMPTY}, "
    treedef = f"PyTreeDef(({head}{_EMPTY}, {adam}, {_EMPTY}))"
    return flat, treedef


def save_checkpoint(ckpt_dir: str, params: dict, epoch: int, seed: int,
                    loss_vec=(), opt_state: dict | None = None,
                    tp: bool = False) -> str:
    """Atomically write ``<ckpt_dir>/ckpt.npz`` + ``meta.json``: the
    parameters and, when given, the named Adam state ``{count, mu, nu}``
    (the trainer's ``unpack_opt_state``; ``tp``: of the tensor-parallel
    chain, full arrays).  In a multi-process run rank 0 alone writes
    (every rank holds the same state); every rank loads the same file."""
    path = os.path.join(ckpt_dir, "ckpt.npz")
    if not host_role():
        return path
    os.makedirs(ckpt_dir, exist_ok=True)
    flat_p = {f"params/{k}": v
              for k, v in _flatten(params_to_numpy(params)).items()}
    flat_o, treedef = ({}, "") if opt_state is None else _opt_entries(
        opt_state, tp)
    meta = {
        "epoch": int(epoch),
        "seed": int(seed),
        "loss_vec": [float(v) for v in loss_vec],
        "opt_treedef": treedef,
        "n_opt_leaves": len(flat_o),
    }
    meta_arr = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    _atomic_write(path, lambda tmp: np.savez(tmp, __meta__=meta_arr,
                                             **flat_p, **flat_o))

    def write_meta(tmp):
        with open(tmp, "w") as f:
            json.dump(meta, f)

    _atomic_write(os.path.join(ckpt_dir, "meta.json"), write_meta)
    return path


def load_checkpoint(ckpt_dir: str, model) -> tuple[dict, int, list[float]]:
    """Restore (params as numpy, next_epoch, loss_vec).

    ``model.init`` supplies the expected names and shapes; any missing
    key or shape mismatch raises.  Convert with
    :func:`mmvae_tpu_torch.models.nb.params_from_numpy`."""
    template = model.init(torch.Generator().manual_seed(0))
    with np.load(os.path.join(ckpt_dir, "ckpt.npz")) as data:
        if "__meta__" in data.files:
            meta = json.loads(bytes(data["__meta__"]).decode())
        else:  # round-1 JAX checkpoints: sidecar json only
            with open(os.path.join(ckpt_dir, "meta.json")) as f:
                meta = json.load(f)
        params = _read_tree(data, template, lambda k: f"params/{k}")
    return params, meta["epoch"] + 1, list(meta["loss_vec"])


def load_opt_state(ckpt_dir: str, model, tp: bool = False) -> dict:
    """The Adam state of a checkpoint written by either package, as
    numpy ``{"count", "mu", "nu"}`` in the named tree (convert with
    :func:`mmvae_tpu_torch.models.nb.adam_from_numpy`): the trainer's
    chain, or with ``tp`` the tensor-parallel one (full arrays).  Raises
    when the checkpoint holds no optimizer state or one of another
    structure (the other chain's included), as JAX's ``load_checkpoint``
    does."""
    template = model.init(torch.Generator().manual_seed(0))
    i = _adam_index(tp)
    with np.load(os.path.join(ckpt_dir, "ckpt.npz")) as data:
        stored = {k for k in data.files if k.startswith("opt/")}
        want = {f"opt/[{i}].count"} | {f"opt/[{i}].{m}{_keystr(k)}"
                                       for m in ("mu", "nu")
                                       for k in _flatten(template)}
        if stored != want:
            raise ValueError(
                f"{ckpt_dir}: optimizer state structure differs; cannot "
                f"resume (missing: {sorted(want - stored)[:3]}, "
                f"unexpected: {sorted(stored - want)[:3]})")
        out = {"count": np.asarray(data[f"opt/[{i}].count"], np.int32)}
        for m in ("mu", "nu"):
            out[m] = _read_tree(data, template,
                                lambda k, m=m: f"opt/[{i}].{m}{_keystr(k)}")
    return out
