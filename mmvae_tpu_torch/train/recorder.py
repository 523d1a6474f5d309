"""Artifact recorder: per-epoch latent posteriors and parameter dumps.

Port of ``mmvae_tpu/train/recorder.py`` (``LatentRecorder``,
``flatten_params``, ``zeropad``) with the same file names and formats:

- ``${out}_<epoch>.{mu_mean,mu_lnvar}.gz`` — N x latent posterior
  matrices assembled batch by batch (reference nbvae_recorder_t,
  include/models/nb.hh:569-662); the vMF-VAE's are
  ``{latent_mean,latent_lnvar}`` (``mean_name`` / ``lnvar_name``);
- ``${out}_<epoch>_<param>.gz`` — every named parameter as gzipped dense
  text, weights in the reference's (out, in) orientation (nb.hh:599-615);
  the mixture's stacked (K, H, R) heads as one file per component;
- ``${out}_<epoch>.clust.gz`` — the mixture's N x K assignments, when the
  encode returns a third output (vmfnb_mixture.hh:797-804).

Writes are synchronous (the JAX package's background writer is not
ported).  In a multi-process run each rank encodes its rows of every
batch and rank 0 gathers them into the (N, width) matrices and writes
(JAX ``LatentRecorder._merged``, ``recorder.py:175-197``).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..io.writers import write_data_file
from ..parallel.multihost import host_role, local_rows


def zeropad(t: int, tmax: int) -> str:
    """Pad ``t`` to the digit width of ``tmax`` (utils/util.hh:98-107)."""
    return str(t).zfill(len(str(tmax)))


def flatten_params(params: dict) -> dict[str, np.ndarray]:
    """Flat {name: array} with reference-style keys and orientation
    (weights are stored (in, out); dumps are (out, in))."""
    out: dict[str, np.ndarray] = {}
    for name, p in params.items():
        if isinstance(p, dict):
            for sub, arr in p.items():
                a = arr.detach().cpu().numpy()
                if a.ndim == 3:
                    # stacked per-component heads: one 2-D entry each
                    for k in range(a.shape[0]):
                        out[f"{name}.{k}.{sub}"] = (a[k].T if sub == "weight"
                                                    else a[k])
                else:
                    out[f"{name}.{sub}"] = (a.T if sub == "weight"
                                            and a.ndim == 2 else a)
        else:
            out[name] = p.detach().cpu().numpy()
    return out


def latent_names(model) -> tuple[str, str]:
    """The posterior artifacts' names of ``model``'s recorder and serving
    CLI: ``mu_mean`` / ``mu_lnvar`` unless the model names its own (the
    vMF-VAE's ``latent_mean`` / ``latent_lnvar``,
    ``mmvae_tpu/cli/vmf_vae.py:73-78``, ``cli/encode.py:100-105``)."""
    return getattr(model, "latent_names", ("mu_mean", "mu_lnvar"))


class LatentRecorder:
    """N x latent posterior collector and artifact writer.

    ``encode_fn(params, x) -> (mean, lnvar)`` is the no-covariate encode
    (the reference records with ``encode_mu(x)``, nb.hh:628), written as
    ``.<mean_name>.gz`` / ``.<lnvar_name>.gz``.  With ``extra_name`` it
    returns a third per-row matrix, written as ``.<extra_name>.gz`` (the
    mixture's assignments, ``clust``)."""

    def __init__(self, header: str, max_epoch: int, ntot: int,
                 encode_fn: Callable, extra_name: str | None = None,
                 mean_name: str = "mu_mean", lnvar_name: str = "mu_lnvar"):
        self.header = header
        self.max_epoch = max_epoch
        self.ntot = ntot
        self.encode_fn = encode_fn
        self.extra_name = extra_name
        self.mean_name = mean_name
        self.lnvar_name = lnvar_name
        self.mean_out = np.zeros((ntot, 0), np.float32)
        self.lnvar_out = np.zeros((ntot, 0), np.float32)
        self.extra_out = np.zeros((ntot, 0), np.float32)

    def encode(self, params: dict, x: torch.Tensor):
        with torch.no_grad():
            return self.encode_fn(params, x)

    def _ensure(self, attr: str, cols: int) -> np.ndarray:
        mat = getattr(self, attr)
        if mat.shape[1] < cols:
            mat = np.zeros((self.ntot, cols), np.float32)
            setattr(self, attr, mat)
        return mat

    def ingest(self, batches, enc) -> None:
        """A whole epoch of posteriors collected on the device: ``enc``
        is the (mean, lnvar[, extra]) tuple of shape (nbatch, B, width),
        applied in batch order so wrap-around duplicates resolve to the
        last visit.  In a multi-process run every rank passes its
        (nbatch, B / world, width) rows of each batch of ``batches`` (the
        global schedule) and rank 0 gathers them."""
        enc = tuple(local_rows(t) for t in enc)
        if not host_role():
            return
        attrs = ("mean_out", "lnvar_out", "extra_out")[:len(enc)]
        for attr, t in zip(attrs, enc):
            a = t.cpu().numpy()
            mat = self._ensure(attr, a.shape[2])
            for b, batch in enumerate(np.asarray(batches)):
                ok = batch < self.ntot
                mat[batch[ok]] = a[b][ok]

    def update_on_epoch(self, params: dict, epoch: int) -> None:
        """Write the epoch's artifacts (rank 0 of a multi-process run)."""
        if not host_role():
            return
        tag = f"{self.header}_{zeropad(epoch, self.max_epoch)}"
        write_data_file(f"{tag}.{self.mean_name}.gz", self.mean_out)
        write_data_file(f"{tag}.{self.lnvar_name}.gz", self.lnvar_out)
        if self.extra_name is not None:
            write_data_file(f"{tag}.{self.extra_name}.gz", self.extra_out)
        for key, arr in flatten_params(params).items():
            write_data_file(f"{tag}_{key}.gz", arr)
