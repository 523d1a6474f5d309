"""Params-only checkpoints in ``mmvae_tpu``'s npz layout.

Port of the parameter half of ``mmvae_tpu/train/checkpoint.py``, numpy
only.  A checkpoint is ``<dir>/ckpt.npz`` holding ``params/<name>/<leaf>``
arrays and a ``__meta__`` JSON record (``epoch``, ``seed``, ``loss_vec``,
``opt_treedef``, ``n_opt_leaves``), plus a ``meta.json`` sidecar.  The
files written here load in ``mmvae_tpu.train.checkpoint.load_checkpoint``
with ``opt_state_template=None``, and JAX checkpoints load here; the
optimizer state comes with the training port.
"""

from __future__ import annotations

import json
import os
import tempfile

import numpy as np
import torch

from ..models.nb import params_to_numpy


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


def save_checkpoint(ckpt_dir: str, params: dict, epoch: int, seed: int,
                    loss_vec=()) -> str:
    """Atomically write ``<ckpt_dir>/ckpt.npz`` + ``meta.json`` with the
    parameters only (no optimizer state)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    flat_p = {f"params/{k}": v
              for k, v in _flatten(params_to_numpy(params)).items()}
    meta = {
        "epoch": int(epoch),
        "seed": int(seed),
        "loss_vec": [float(v) for v in loss_vec],
        "opt_treedef": "",
        "n_opt_leaves": 0,
    }
    meta_arr = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    path = os.path.join(ckpt_dir, "ckpt.npz")
    _atomic_write(path, lambda tmp: np.savez(tmp, __meta__=meta_arr,
                                             **flat_p))

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
        params: dict = {}
        for key, leaf in _flatten(template).items():
            arr = data[f"params/{key}"]
            if arr.shape != tuple(leaf.shape):
                raise ValueError(f"checkpoint shape mismatch for {key}: "
                                 f"{arr.shape} vs {tuple(leaf.shape)}")
            node = params
            *parents, name = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[name] = arr
    return params, meta["epoch"] + 1, list(meta["loss_vec"])
