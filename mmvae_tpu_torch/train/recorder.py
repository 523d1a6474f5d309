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

With ``async_writes`` (the trainer CLIs' setting, as in JAX) the row
scatter into the (N, width) matrices, the text formatting and the gzip
run on one background thread, in submission order, while training goes
on; everything that touches the device or a collective (encoding, the
gather of a multi-process run's rows, the device-to-host copies) stays
on the caller's thread, so the writer thread sees host arrays only.  In
a multi-process run each rank encodes its rows of every batch and rank
0 gathers them into the matrices and writes (JAX
``LatentRecorder._merged``, ``recorder.py:175-197``).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor, wait
from typing import Callable

import numpy as np
import torch

from ..io.writers import write_data_file
from ..ops.nb_fast import tree_leaves
from ..parallel.multihost import host_role, local_rows


def zeropad(t: int, tmax: int) -> str:
    """Pad ``t`` to the digit width of ``tmax`` (utils/util.hh:98-107)."""
    return str(t).zfill(len(str(tmax)))


def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` that shares no memory with it (``.numpy()``
    of a CPU tensor would)."""
    return t.detach().to("cpu", copy=True).numpy()


def flatten_params(params: dict) -> dict[str, np.ndarray]:
    """Flat {name: array} with reference-style keys and orientation
    (weights are stored (in, out); dumps are (out, in)), copied to the
    host."""
    out: dict[str, np.ndarray] = {}
    for name, p in params.items():
        if isinstance(p, dict):
            for sub, arr in p.items():
                a = _host(arr)
                if a.ndim == 3:
                    # stacked per-component heads: one 2-D entry each
                    for k in range(a.shape[0]):
                        out[f"{name}.{k}.{sub}"] = (a[k].T if sub == "weight"
                                                    else a[k])
                else:
                    out[f"{name}.{sub}"] = (a.T if sub == "weight"
                                            and a.ndim == 2 else a)
        else:
            out[name] = _host(p)
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
    mixture's assignments, ``clust``).

    ``async_writes`` (JAX ``recorder.py:95-103``): the matrices belong to
    one writer thread, which runs every scatter and every epoch's writes
    in submission order, so an epoch's files hold the rows as they stood
    when the epoch was submitted, whatever is ingested after it.  An
    error of a finished task surfaces at the next submission
    (:meth:`_bound_queue`) or at :meth:`flush`, which joins every task;
    read the files or the matrices after :meth:`flush`."""

    def __init__(self, header: str, max_epoch: int, ntot: int,
                 encode_fn: Callable, extra_name: str | None = None,
                 mean_name: str = "mu_mean", lnvar_name: str = "mu_lnvar",
                 async_writes: bool = False):
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
        self._writer = (ThreadPoolExecutor(max_workers=1)
                        if async_writes else None)
        self._pending: list = []

    def encode(self, params: dict, x: torch.Tensor):
        with torch.no_grad():
            return self.encode_fn(params, x)

    def _ensure(self, attr: str, cols: int) -> np.ndarray:
        mat = getattr(self, attr)
        if mat.shape[1] < cols:
            mat = np.zeros((self.ntot, cols), np.float32)
            setattr(self, attr, mat)
        return mat

    def _submit(self, fn) -> None:
        """``fn()`` on the writer thread after every earlier submission,
        or here and now when writes are synchronous."""
        if self._writer is None:
            fn()
            return
        self._bound_queue()
        self._pending.append(self._writer.submit(fn))

    def flush(self) -> None:
        """Join every pending task, then raise the first error among
        them."""
        pending, self._pending = self._pending, []
        wait(pending)
        for fut in pending:
            fut.result()

    def _bound_queue(self, limit: int = 64) -> None:
        """Raise the error of a finished task without waiting for the
        others; wait only when more than ``limit`` tasks are pending."""
        done = [f for f in self._pending if f.done()]
        self._pending = [f for f in self._pending if not f.done()]
        for f in done:
            f.result()
        if len(self._pending) > limit:
            self.flush()

    def _scatter(self, batches: np.ndarray, outs: tuple) -> None:
        """Rows of each batch's (B, width) outputs into the matrices, in
        batch order: a row visited twice (the wrap-around schedule) keeps
        its last visit."""
        attrs = ("mean_out", "lnvar_out", "extra_out")[:len(outs)]
        for attr, a in zip(attrs, outs):
            mat = self._ensure(attr, a.shape[2])
            for b, batch in enumerate(batches):
                ok = batch < self.ntot
                mat[batch[ok]] = a[b][ok]

    def ingest(self, batches, enc, mesh=None) -> None:
        """A whole epoch of posteriors collected on the device: ``enc``
        is the (mean, lnvar[, extra]) tuple of shape (nbatch, B, width),
        applied in batch order so wrap-around duplicates resolve to the
        last visit.  In a multi-process run every rank passes its
        (nbatch, B / ndata, width) rows of each batch of ``batches`` (the
        global schedule) and rank 0 gathers them (over the data axis of
        ``mesh`` under tensor parallelism, whose model rows hold the same
        outputs)."""
        enc = tuple(local_rows(t, mesh) for t in enc)
        if not host_role():
            return
        host = tuple(_host(t) for t in enc)
        batches = np.asarray(batches)
        self._submit(lambda: self._scatter(batches, host))

    def update_on_batch(self, params: dict, x, batch) -> None:
        """Encode one batch ``x`` (host counts or a tensor; moved to the
        parameters' device) and record its rows (JAX's host recording
        path, ``recorder.py:120-147``; one process): a row visited again
        keeps its last visit."""
        dev = tree_leaves(params)[0].device
        outs = self.encode(params, torch.as_tensor(x, device=dev))
        host = tuple(_host(t)[None] for t in outs)
        batch = np.asarray(batch)[None]
        self._submit(lambda: self._scatter(batch, host))

    def update_on_epoch(self, params: dict, epoch: int) -> None:
        """Write the epoch's artifacts (rank 0 of a multi-process run):
        the matrices as they stand after every earlier submission, and
        ``params`` as they are now."""
        if not host_role():
            return
        flat = flatten_params(params)
        self._submit(lambda: self._write_epoch(flat, epoch))

    def submit_epoch(self, batches, enc, params: dict, epoch: int,
                     mesh=None) -> None:
        """:meth:`ingest` then :meth:`update_on_epoch` of one recording
        epoch (JAX ``submit_epoch``, ``recorder.py:314-351``): call it
        after the epoch's loss fetch, when the device copies no longer
        wait on the epoch's compute; with ``async_writes`` it returns once
        they are made."""
        self.ingest(batches, enc, mesh)
        self.update_on_epoch(params, epoch)

    def _write_epoch(self, flat: dict, epoch: int) -> None:
        tag = f"{self.header}_{zeropad(epoch, self.max_epoch)}"
        write_data_file(f"{tag}.{self.mean_name}.gz", self.mean_out)
        write_data_file(f"{tag}.{self.lnvar_name}.gz", self.lnvar_out)
        if self.extra_name is not None:
            write_data_file(f"{tag}.{self.extra_name}.gz", self.extra_out)
        for key, arr in flat.items():
            write_data_file(f"{tag}_{key}.gz", arr)

