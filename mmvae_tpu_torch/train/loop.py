"""Training epochs, whole-dataset encoding sweeps, the resident matrix.

Ports of ``mmvae_tpu/train/loop.py`` (``_as_memory_block``,
``_build_dense``, ``Trainer.make_ondevice_epoch``,
``Trainer.make_rotating_epoch`` and the single-device paths of
``train_vae_model``) and of the two sweeps of ``mmvae_tpu/cli/encode.py``:

- :class:`DenseEpochRunner` / :func:`train_vae_model`: each epoch walks
  the reference's sequential wrap-around batch schedule through a step —
  a packed fast step (any
  :class:`~mmvae_tpu_torch.ops.nb_fast.PackedFastStep`) or the generic
  :class:`Trainer` (``Trainer._batch_step`` on the named parameter tree)
  — with every random draw of the epoch made up front.  The batches come
  from one of four tiers (:func:`load_batches`, JAX's choice): the
  (N, D) counts resident on the device in their narrow dtype; padded-ELL
  arrays on the device, densified a batch at a time
  (:class:`EllBatches`); host-resident shards rotated through the device
  (:class:`RotatingBatches`); or batches read from the file on the host
  (:class:`StreamedBatches`).  Every tier gives the same batches and
  draws, so the same bits;
- :func:`encode_resident`: ``chunk`` batches of B rows go through the
  encoder per kernel launch (the encoder works row by row, and the
  mixture's per-batch noise is tiled over the chunk, so grouping changes
  no result);
- :func:`encode_streaming`: batches read from the out-of-core block in
  the reference's sequential wrap-around order, ``chunk`` batches per
  host->device copy.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..data.block import MtxDataBlock, MtxMemoryBlock
from ..data.pipeline import PrefetchLoader, sequential_batches
from ..data.shards import ShardStore
from ..io import native
from ..ops.densify import DeviceCSC, densify_gathered, densify_triplets
from ..ops.losses import kl_weight_schedule
from ..ops.nb_fast import (PackedAdam, batch_rand, draw_rand, reduce_step,
                           tree_leaves, tree_unflatten)
from ..parallel.collectives import pmean, psum
from ..parallel.mesh import gather_params
from ..parallel.multihost import host_role, sharded_batches
from ..utils.logging import TLOG
from ..utils.metrics import MetricsLogger
from ..utils.profiling import StepTimer, annotate, trace


def as_memory_block(block):
    """Coerce a data block to an in-memory (CSC) block."""
    if isinstance(block, MtxDataBlock):
        return MtxMemoryBlock(block.mtx_file, block.idx_file, block.B)
    return block


def build_dense(block, device: torch.device | str,
                order: np.ndarray | None = None,
                features: slice | None = None) -> torch.Tensor:
    """The (N, D) count matrix on ``device`` in the block's ``val_dtype``
    (int8, int16 or float32): filled on the host — the native one-pass
    fill when the C++ extension loads, a numpy scatter of the CSC arrays
    otherwise — then ONE host->device copy.  ``order`` keeps only those
    cells, in that order (a rank's rows of a data-parallel run);
    ``features`` only those features, cut on the host before the copy (a
    rank's block under tensor parallelism)."""
    blk = as_memory_block(block)
    rows, vals, indptr = blk.csc_arrays()
    vd = np.dtype(getattr(blk, "val_dtype", np.float32))
    if native.available():
        TLOG("dense fill: native")
        host = native.dense_fill(rows, vals, indptr, blk.nfeature(), vd,
                                 order)
    else:
        TLOG("dense fill: numpy (native extension unavailable)")
        host = np.zeros((len(indptr) - 1, blk.nfeature()), vd)
        cols = np.repeat(np.arange(len(indptr) - 1), np.diff(indptr))
        host[cols, rows] = vals.astype(vd)
        if order is not None:
            host = host[order]
    if features is not None:
        host = np.ascontiguousarray(host[:, features])
    return torch.from_numpy(host).to(device)


def encode_resident(model, params: dict, data: torch.Tensor, B: int,
                    chunk: int, prep: dict | None = None,
                    encode_fn=None) -> tuple:
    """(N, width) outputs of the encoder — mean and log-variance, and
    the mixture's assignments — for every row of the device-resident
    ``data`` (N % B == 0), ``chunk`` batches per encoder call.  ``prep``
    is ``model.prepare_encoder``'s result (made here when None);
    ``encode_fn(params, x)`` replaces the folded encoder (the tensor-
    parallel sweep passes the model's ``tp_record_encoder``, on this
    rank's block of the features)."""
    N = data.shape[0]
    if N % B:
        raise ValueError(f"resident sweep needs N % B == 0 (N={N}, B={B})")
    if encode_fn is None:
        if prep is None:
            prep = model.prepare_encoder(params)

        def encode_fn(p, x):
            return model.encode_prepared(p, prep, x)
    rows = max(1, chunk) * B
    outs = [encode_fn(params, data[lo:lo + rows])
            for lo in range(0, N, rows)]
    return tuple(torch.cat(parts) for parts in zip(*outs))


def encode_streaming(model, params: dict, db, B: int, chunk: int,
                     device: torch.device | str, prep: dict | None = None
                     ) -> tuple:
    """(N, width) host outputs of the encoder (as
    :func:`encode_resident`) over the reference's sequential wrap-around
    batches read from ``db``; ``chunk`` batches ride one host->device
    copy and one encoder call."""
    N, D = db.ntot(), db.nfeature()
    batches = sequential_batches(N, B)
    if prep is None:
        prep = model.prepare_encoder(params)
    chunk = max(1, chunk)
    host = None
    for i in range(0, len(batches), chunk):
        grp = batches[i:i + chunk]
        xs = np.empty((len(grp) * B, D), np.float32)
        for j, batch in enumerate(grp):
            db.clear()
            xs[j * B:(j + 1) * B] = db.read(batch)
        outs = [t.cpu().numpy() for t in model.encode_prepared(
            params, prep, torch.from_numpy(xs).to(device))]
        if host is None:
            host = [np.zeros((N, o.shape[1]), np.float32) for o in outs]
        for j, batch in enumerate(grp):
            # wrapped duplicates rewrite identical rows
            for h, o in zip(host, outs):
                h[batch] = o[j * B:(j + 1) * B]
    return tuple(host)


class Trainer:
    """The generic batch step (JAX ``Trainer``, train/loop.py:109-137,
    ``_batch_step`` :275-339) on the NAMED parameter tree, behind the
    packed steps' protocol so :class:`DenseEpochRunner` and
    :func:`train_vae_model` drive it unchanged: ``pack`` / ``unpack`` /
    ``pack_opt_state`` / ``unpack_opt_state`` are identities, the
    optimizer is the JAX chain over the named tree, and ``draw_rand`` has
    the packed steps' structure (``rep_eps`` (B, R) and (B, Rn), ``ridx``
    (nboot, B), ``boot_eps``), which JAX's ``_draw_batch`` documents as
    equal to ``_batch_step``'s in-step draws.

    ``forward(params, x, c, eps, training)`` and ``loss_fn(x, out, beta)``
    make the reporting loss, ``boot_loss_fn`` (default ``loss_fn``) the
    boot losses; ``report_loss_override`` / ``boot_loss_override`` with
    signature ``(params, x, c, eps, beta)`` replace forward + loss, as
    the models' fused losses do.  ``eps_widths`` are the latent widths of
    the reparameterization draws (NB: ``(mean_latent,
    overdisp_latent)``).  Counts stay in their resident dtype.

    Tensor parallelism (JAX's ``tp_shard_map``, train/loop.py:137-270):
    ``tp_pspecs`` is the model's ``tp_pspecs`` tree, the parameters and
    the counts are this rank's shards, and the overrides are the models'
    ``fused_step_*_tp`` (or the vMF-VAE's ``tp_step_loss``) bound to the
    model row.  The optimizer is then the chain without the clip, and
    each boot step's gradients (``pmean``-ed over the data column first)
    are clipped against the norm across the model row (:func:`tp_clip`)."""

    def __init__(self, forward, loss_fn, opt, *, eps_widths,
                 kl=(1.0, 1e-2, 0.1), boot_loss_fn=None,
                 report_loss_override=None, boot_loss_override=None,
                 tp_pspecs=None):
        self.forward, self.loss_fn = forward, loss_fn
        self.boot_loss_fn = boot_loss_fn if boot_loss_fn is not None \
            else loss_fn
        self._report_override = report_loss_override
        self._boot_override = boot_loss_override
        self.opt = opt
        self.kl_max, self.kl_min, self.kl_discount = kl
        self.eps_widths = tuple(eps_widths)
        self.tp_pspecs = tp_pspecs
        self._tp_split = (None if tp_pspecs is None else
                          [a is not None for a in tree_leaves(tp_pspecs)])
        self.optimizer = PackedAdam(opt.lr, opt.grad_clip, opt.weight_decay,
                                    tp=tp_pspecs is not None)
        self._beta = None

    @staticmethod
    def pack(t: dict) -> dict:
        return t

    unpack = pack_opt_state = unpack_opt_state = pack

    def draw_rand(self, gen: torch.Generator, nbatch: int, B: int) -> dict:
        return draw_rand(gen, nbatch, B, self.opt.nboot, self.eps_widths)

    def _beta_for(self, epoch_f: float, device) -> torch.Tensor:
        key = (float(epoch_f), str(device))
        if self._beta is None or self._beta[0] != key:
            beta = kl_weight_schedule(epoch_f, self.kl_max, self.kl_min,
                                      self.kl_discount).to(device)
            self._beta = (key, beta)
        return self._beta[1]

    def _report(self, params, x, c, eps, beta):
        if self._report_override is not None:
            return self._report_override(params, x, c, eps, beta)
        return self.loss_fn(x, self.forward(params, x, c, eps, True), beta)

    def _boot(self, params, x, c, eps, beta):
        if self._boot_override is not None:
            return self._boot_override(params, x, c, eps, beta)
        return self.boot_loss_fn(x, self.forward(params, x, c, eps, True),
                                 beta)

    def batch_step(self, params: dict, opt_state: dict, x, c, epoch_f,
                   rand: dict, mesh=None):
        """The reporting loss (no update) and ``nboot`` bootstrap Adam
        steps, each on the resampled input rows ``x[ridx]``
        (mmvae_alg.hh:277-311).  Returns (params, opt_state, report).
        ``mesh`` as in the packed steps' ``batch_step``: every leaf's
        gradient (and, with the first, the report) ``pmean``-ed in one
        flat buffer in ``PackedAdam``'s leaf order, over the data column
        under tensor parallelism (nothing to average with one data
        index), then clipped across the model row."""
        beta = self._beta_for(epoch_f, x.device)
        xs, cs = x, c
        reduce_data, group = mesh is not None, None
        if mesh is not None:
            xs, cs, rand = mesh.step_inputs(x, c, rand)
            if mesh.tp:
                reduce_data, group = mesh.data_group is not None, \
                    mesh.data_group
        with torch.no_grad():
            report = self._report(params, x, c, rand["rep_eps"], beta)
        for i in range(self.opt.nboot):
            ridx = rand["ridx"][i]
            xb, cb = xs.index_select(0, ridx), cs.index_select(0, ridx)
            leaves = [v.detach().requires_grad_() for v in
                      tree_leaves(params)]
            loss = self._boot(tree_unflatten(params, leaves), xb, cb,
                              tuple(e[i] for e in rand["boot_eps"]), beta)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            # a leaf the loss does not reach has a zero gradient, as in JAX
            grads = [torch.zeros_like(v) if g is None else g
                     for g, v in zip(grads, leaves)]
            if reduce_data:
                grads, report = reduce_step(grads, report, i, group)
            with torch.no_grad():
                if self._tp_split is not None:
                    grads = tp_clip(grads, self._tp_split, mesh.model_group,
                                    self.opt.grad_clip)
                params, opt_state = self.optimizer.update(
                    tree_unflatten(params, grads), opt_state, params)
        if reduce_data and self.opt.nboot == 0:
            report = pmean([report], group)[0]
        return params, opt_state, report


def tp_clip(grads: list, split: list, group, max_norm: float) -> list:
    """JAX's ``_make_tp_clip`` (train/loop.py:244-270): the global norm
    across the model row is the sum over the row of the split leaves'
    square sums, plus the replicated leaves' square sum counted once
    (each summed in leaf order from 0.0); every gradient is scaled by
    ``max / max(norm, max)``.  Not ``PackedAdam``'s ``g / norm * max``:
    the bits differ."""
    zero = torch.zeros((), dtype=torch.float32, device=grads[0].device)
    sq_sh, sq_rp = zero, zero
    for g, sp in zip(grads, split):
        if sp:
            sq_sh = sq_sh + torch.sum(torch.square(g))
        else:
            sq_rp = sq_rp + torch.sum(torch.square(g))
    total = psum([sq_sh.reshape(1)], group)[0].reshape(()) + sq_rp
    scale = max_norm / torch.clamp_min(torch.sqrt(total), max_norm)
    return [g * scale for g in grads]


def epoch_generator(seed: int, epoch: int, device,
                    rank: int | None = None) -> torch.Generator:
    """The generator of one epoch's draws: a pure function of (seed,
    epoch), so a resumed run draws what the uninterrupted one drew.  A
    ``--dp_shard`` rank's is a pure function of (seed, epoch, rank), the
    counterpart of JAX's ``fold_in(key, axis_index)``; under tensor
    parallelism ``rank`` is the data index, folded in even when the data
    axis has one index, as JAX folds it."""
    gen = torch.Generator(device=device)
    s = (int(seed) << 20) + int(epoch)
    if rank is not None:
        s = ((s << 12) + int(rank) + 1) & ((1 << 64) - 1)
    gen.manual_seed(s)
    return gen


def schedule_cols(N: int, B: int, device) -> torch.Tensor:
    """The (nbatch, B) cell ids of the reference's sequential wrap-around
    schedule (mmvae_alg.hh:261-266) on ``device``."""
    return torch.from_numpy(np.stack(sequential_batches(N, B))).to(device)


class ResidentBatches:
    """Batches of the dense-resident tier: the (N, D) counts live on the
    device in their narrow dtype; batch b is a contiguous slice when
    N % B == 0, else a row gather of its wrap-around schedule."""

    def __init__(self, data: torch.Tensor, B: int):
        self.data, self.B = data, B
        self.N, self.device = data.shape[0], data.device
        self.nbatch = -(-self.N // B)
        self.cols = None if self.N % B == 0 else schedule_cols(
            self.N, B, self.device)

    def batches(self):
        for b in range(self.nbatch):
            if self.cols is None:
                yield self.data[b * self.B:(b + 1) * self.B], None
            else:
                yield self.data.index_select(0, self.cols[b]), None


class EllBatches:
    """Batches of the ELL-resident tier (the ELL branch of JAX's
    ``make_ondevice_epoch``, train/loop.py:411-556): the padded-ELL
    arrays live on the device and each batch is densified there."""

    def __init__(self, csc, B: int):
        self.csc, self.B = csc, B
        self.N, self.device = csc.N, csc.ell_rows.device
        self.cols = schedule_cols(self.N, B, self.device)
        self.nbatch = len(self.cols)

    def batches(self):
        for cols in self.cols:
            yield self.csc.densify(cols), None


class RotatingBatches:
    """Batches of the rotating tier (JAX's ``make_rotating_epoch``,
    train/loop.py:559-757): one pass over the host-resident shards of a
    :class:`~mmvae_tpu_torch.data.shards.ShardStore` an epoch, each
    shard's batches contiguous slices of it, densified on the device.

    The next rotating shard's copy is issued before the current shard's
    batches, so it overlaps their compute, and the last shard prefetches
    the next epoch's first rotating shard (``_carry``).  Before a new
    copy is issued, the compute of the rotating shard before last must
    have finished, so about three rotating buffers are alive at most.
    The batches, their order and their random draws (sliced by global
    batch id) are the dense-resident tier's, so the bits are too."""

    def __init__(self, store):
        self.store, self.B = store, store.B
        self.N, self.device = store.ntot, store.device
        self.nbatch = -(-self.N // self.B)
        self.rotating = [r for r in range(store.nshards)
                         if r not in store.pinned_idx]
        self._carry = None     # (index, ShardCopy) of the prefetched shard
        self._done: list = []  # end of each rotating shard's compute

    def _next_rot(self, after: int):
        """The first rotating shard after ``after``, wrapping to the next
        epoch's first."""
        for r in self.rotating:
            if r > after:
                return r
        return self.rotating[0] if self.rotating else None

    def _batch(self, arrays: tuple, i: int) -> torch.Tensor:
        B, D, layout = self.B, self.store.D, self.store.layout
        if layout == "csr":
            return densify_triplets(*(a[i] for a in arrays), B, D)
        rows = slice(i * B, (i + 1) * B)
        if layout == "dense":
            return arrays[0][rows]
        return densify_gathered(arrays[0][rows], arrays[1][rows], D)

    def batches(self):
        store, cuda = self.store, self.device.type == "cuda"
        for r in range(store.nshards):
            if self._carry is not None and self._carry[0] == r:
                dev, self._carry = self._carry[1], None
            else:
                # resident shards after their first copy; rotating ones
                # on the first epoch, or when R == 1
                dev = store.put(r)
            nxt = self._next_rot(r)
            if nxt is not None and self._carry is None:
                if len(self._done) >= 2:
                    self._done.pop(0).synchronize()
                self._carry = (nxt, store.put(nxt))
            arrays = dev.take()
            for i in range(store.shards[r].nb):
                yield self._batch(arrays, i), None
            if cuda and r in self.rotating:
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(self.device))
                self._done.append(ev)


class StreamedBatches:
    """Batches of the host-streaming tier (the host path of JAX's
    ``train_vae_model``, train/loop.py:1686-1790): each epoch reads the
    batches from the data block (the BGZF file for a streaming block)
    through :class:`~mmvae_tpu_torch.data.pipeline.PrefetchLoader`, the
    covariate from its block, and copies them to the device from
    page-locked memory.  One batch a step; JAX's superbatches only group
    XLA dispatches.  ``schedule`` is the cell ids of each batch (default
    the sequential one over blocks of B; a data-parallel rank's slices of
    the global one, ``parallel.multihost.sharded_batches``); ``features``
    the features to keep, cut on the host before the copy (a rank's block
    under tensor parallelism)."""

    def __init__(self, data_block, covar_block, B: int, device,
                 schedule=None, features: slice | None = None):
        self.data_block, self.covar_block, self.B = (data_block, covar_block,
                                                     B)
        self.features = features
        self.N, self.device = data_block.ntot(), torch.device(device)
        self.schedule = (sequential_batches(self.N, B) if schedule is None
                         else schedule)
        self.nbatch = len(self.schedule)

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(a)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def batches(self):
        loader = PrefetchLoader(self.data_block, self.covar_block,
                                self.schedule, depth=2)
        for _, x, c in loader:
            if self.features is not None:
                x = np.ascontiguousarray(x[:, self.features])
            yield self._to_device(x), self._to_device(c).float()


class DenseEpochRunner:
    """One training epoch of dense (B, D) batches through a step (the
    epoch of JAX's ``Trainer.make_ondevice_epoch``, train/loop.py:
    411-556, ``make_rotating_epoch`` (:559-757) and the host path of
    ``train_vae_model``).

    ``data`` is the device-resident (N, D) count tensor (the
    dense-resident tier) or a batch source of another tier
    (:class:`EllBatches`, :class:`RotatingBatches`,
    :class:`StreamedBatches`), whose ``batches()`` yields each batch of
    the reference's sequential wrap-around schedule (mmvae_alg.hh:
    261-266) in order, with its covariate rows or None.  ``fast`` is a
    packed step or a :class:`Trainer`.  The covariate is the all-ones
    column unless a dense (N, C) covariate matrix is given (or the
    source reads its own).  ``record_fn(params, x) -> (mean, lnvar[,
    extra])`` is evaluated right after each batch's updates on a
    recording epoch (the recorder's observation point,
    mmvae_alg.hh:315-317).

    With a :class:`~mmvae_tpu_torch.parallel.mesh.DataMesh` (world > 1)
    ``B`` is the global batch and the source yields this rank's M = B /
    world rows of each (a tensor ``data`` holds only those rows, batch
    after batch); the draws are the global batch's under
    ``data_parallel`` and the rank's own M rows' under ``dp_shard``, and
    ``record_fn`` sees the rank's rows."""

    def __init__(self, fast, data, B: int, seed: int = 0,
                 covar: torch.Tensor | None = None, covar_dim: int = 1,
                 record_fn=None, mesh=None):
        self.fast, self.B, self.seed, self.mesh = fast, B, seed, mesh
        M = B if mesh is None else mesh.local_batch(B)
        self.source = (ResidentBatches(data, M)
                       if isinstance(data, torch.Tensor) else data)
        self.covar, self.record_fn = covar, record_fn
        self.N = self.source.N
        self.nbatch = self.source.nbatch
        self.device = self.source.device
        self.ones = torch.ones((M, covar_dim), dtype=torch.float32,
                               device=self.device)
        if mesh is not None and covar is not None:
            raise ValueError("a data-parallel source reads its own "
                             "covariate rows")
        self.cols = (None if covar is None or self.N % B == 0
                     else schedule_cols(self.N, B, self.device))

    def draw(self, epoch: int) -> dict:
        if self.mesh is not None and self.mesh.shard:
            return self.fast.draw_rand(
                epoch_generator(self.seed, epoch, self.device,
                                self.mesh.data_index), self.nbatch,
                self.mesh.local_batch(self.B))
        return self.fast.draw_rand(
            epoch_generator(self.seed, epoch, self.device), self.nbatch,
            self.B)

    def _covar(self, b: int) -> torch.Tensor:
        if self.covar is None:
            return self.ones
        if self.cols is None:
            return self.covar[b * self.B:(b + 1) * self.B]
        return self.covar.index_select(0, self.cols[b])

    def __call__(self, q: dict, opt_state: dict, epoch: int,
                 record: bool = False, rand: dict | None = None):
        """Run one epoch; returns (q, opt_state, reports (nbatch,), the
        record_fn outputs stacked to (nbatch, B, width) on a recording
        epoch, else None).  ``rand`` overrides the epoch's draws (tests
        feed the JAX package's)."""
        rand = self.draw(epoch) if rand is None else rand
        reps = torch.empty(self.nbatch, dtype=torch.float32,
                           device=self.device)
        enc = None
        for b, (x, c) in enumerate(self.source.batches()):
            c = self._covar(b) if c is None else c
            q, opt_state, rep = self.fast.batch_step(
                q, opt_state, x, c, float(epoch), batch_rand(rand, b),
                mesh=self.mesh)
            reps[b] = rep
            if record:
                outs = self.record_fn(self.fast.unpack(q), x)
                if enc is None:
                    enc = tuple(torch.empty((self.nbatch, *t.shape),
                                            dtype=t.dtype, device=t.device)
                                for t in outs)
                for e, t in zip(enc, outs):
                    e[b] = t
        return q, opt_state, reps, enc


def _env_bytes(name: str, default: int) -> int:
    return int(os.environ.get(name) or default)


def load_dp_batches(data_block, covar_block, opt, device, mesh):
    """The tier of a data-parallel or tensor-parallel rank, JAX's rule
    under a mesh (train/loop.py:1281-1420): the blocks read this data
    index's M = B / ndata rows of every global batch.  Dense-resident
    epochs need ``--dp_shard`` (or tensor parallelism) and a wrap-free
    schedule (JAX's ``dp_ondevice_ok`` / ``tp_ondevice_ok``; JAX's
    one-host condition on TP is a limit of its global arrays, and each
    rank here fills its own block); they are auto-enabled when the whole
    dense matrix fits ``MMVAE_ONDEVICE_BYTES``, logged with JAX's line,
    and then taken only with the all-ones covariate.  The rank holds its
    rows of every batch, batch after batch, and under tensor parallelism
    only its block of the features, cut on the host before the copy.
    Otherwise the host-streaming tier over the data index's slices of the
    global schedule (``parallel.multihost.sharded_batches``), with JAX's
    line when on-device epochs were asked for or auto-enabled.  Returns
    what :func:`load_batches` returns."""
    ntot, M = data_block.ntot(), data_block.size()
    B = M * mesh.ndata
    ondevice = bool(getattr(opt, "ondevice", False))
    dense_ok = mesh.shard and ntot % B == 0
    vd = np.dtype(getattr(data_block, "val_dtype", np.float32))
    D = data_block.nfeature()
    dense_bytes = ntot * D * vd.itemsize
    if (not ondevice and getattr(opt, "auto_ondevice", True) and dense_ok
            and isinstance(data_block, MtxMemoryBlock)):
        if 0 < dense_bytes <= _env_bytes("MMVAE_ONDEVICE_BYTES", 4 << 30):
            TLOG(f"Auto-enabling on-device epochs (~{dense_bytes / 1e6:,.0f}"
                 " MB; --no_auto_ondevice to disable)")
            ondevice = True
    schedule = sharded_batches(ntot, B, mesh.data_index, mesh.ndata)
    cols = mesh.local_cols(D) if mesh.tp else None
    if ondevice and dense_ok and getattr(covar_block, "auto_ones", False):
        share = dense_bytes / mesh.world / 1e6
        if mesh.tp:
            TLOG(f"Loading data on device (dense-resident, TP layout over "
                 f"(data={mesh.ndata}, model={mesh.model}), {share:,.0f} MB "
                 f"{vd.name} a rank)")
        else:
            TLOG(f"Loading data on device (dense-resident, DP layout over "
                 f"{mesh.world} processes, {share:,.0f} MB {vd.name} a "
                 f"rank)")
        return (build_dense(data_block, device, np.concatenate(schedule),
                            cols), None, True)
    if ondevice:
        TLOG("on-device epochs with a mesh need --dp_shard or "
             "--tensor_parallel, a wrap-free schedule, and the all-ones "
             "covariate; falling back to the host loop")
    return (StreamedBatches(data_block, covar_block, M, device, schedule,
                            cols), None, False)


def load_batches(data_block, covar_block, opt, device, mesh=None):
    """The tier of JAX's ``train_vae_model`` (train/loop.py:1288-1545,
    single device, no feature clustering) for these blocks and options,
    loaded: returns (source, dense covariate or None, on-device?), the
    source being the (N, D) tensor of the dense-resident tier or the
    batch source of another tier, each logged with JAX's line.  A
    data-parallel rank (``mesh``) takes :func:`load_dp_batches`.

    - ``--ondevice``, or auto-enabled (``opt.auto_ondevice``) for an
      in-memory block when the smaller of its dense and ELL sizes fits
      ``MMVAE_ONDEVICE_BYTES`` (4 GiB) — beyond it, rotation unless
      ``MMVAE_ROTATE=0`` — and then, under ``MMVAE_DENSE_BYTES``
      (6 GiB; the auto-rotation budget if that is smaller): the
      dense-resident tier when the dense matrix fits; the ELL tier when
      ELL fits or ``MMVAE_ROTATE=0``; otherwise rotating shards of
      ``MMVAE_SHARD_BYTES`` (default max(64 MB, budget / 8)) with
      ``MMVAE_PIN_BYTES`` (default budget - 3 shards) of them resident;
    - otherwise (a streaming block, or ``--no_auto_ondevice``) the
      host-streaming tier, which loads nothing into memory."""
    if mesh is not None:
        return load_dp_batches(data_block, covar_block, opt, device, mesh)
    ntot, B = data_block.ntot(), data_block.size()
    ondevice = bool(getattr(opt, "ondevice", False))
    auto_rotate_budget = None
    if (not ondevice and getattr(opt, "auto_ondevice", True)
            and isinstance(data_block, MtxMemoryBlock)):
        vd_item = np.dtype(getattr(data_block, "val_dtype",
                                   np.float32)).itemsize
        need = min(8 * ntot * data_block.k_max(),
                   vd_item * ntot * data_block.nfeature())
        budget = _env_bytes("MMVAE_ONDEVICE_BYTES", 4 << 30)
        if 0 < need <= budget:
            TLOG(f"Auto-enabling on-device epochs (~{need / 1e6:,.0f} MB; "
                 "--no_auto_ondevice to disable)")
            ondevice = True
        elif need > budget and os.environ.get("MMVAE_ROTATE", "1") != "0":
            TLOG(f"Auto-enabling rotating-shard on-device epochs "
                 f"(~{need / 1e6:,.0f} MB exceeds the {budget / 1e6:,.0f} "
                 "MB resident budget; --no_auto_ondevice or MMVAE_ROTATE=0 "
                 "to disable)")
            ondevice = True
            auto_rotate_budget = budget
    if not ondevice:
        return StreamedBatches(data_block, covar_block, B, device), None, \
            False

    # --ondevice on a streaming block loads it, as in JAX
    data_mem = as_memory_block(data_block)
    covar = None
    if not getattr(covar_block, "auto_ones", False):
        covar = build_dense(covar_block, device).float()
    vd = np.dtype(getattr(data_mem, "val_dtype", np.float32))
    dense_bytes = ntot * data_mem.nfeature() * vd.itemsize
    ell_bytes = ntot * data_mem.k_max() * (4 + vd.itemsize)
    budget = _env_bytes("MMVAE_DENSE_BYTES", 6 << 30)
    if auto_rotate_budget is not None:
        budget = min(budget, auto_rotate_budget)
    if 0 < dense_bytes <= budget:
        TLOG(f"Loading data on device (dense-resident, "
             f"{dense_bytes / 1e6:,.0f} MB {vd.name})")
        TLOG("Feature clustering is not applied (not ported yet, "
             "ROADMAP.md Queue 1 item 8): genes stay in input order")
        return build_dense(data_mem, device), covar, True
    if 0 < ell_bytes <= budget or os.environ.get("MMVAE_ROTATE", "1") == "0":
        TLOG("Loading data on device (ELL layout)")
        csc = DeviceCSC.from_memory_block(data_mem, count_dtype="auto",
                                          device=device)
        return EllBatches(csc, B), covar, True
    # shards of ~budget/8 keep the rotating buffers a small share of the
    # budget; the rest keeps shards resident, less three shard slots (the
    # previous shard, the current one and the next one's copy)
    shard_budget = _env_bytes("MMVAE_SHARD_BYTES", max(64 << 20, budget // 8))
    pin_budget = _env_bytes("MMVAE_PIN_BYTES",
                            max(0, budget - 3 * shard_budget))
    store = ShardStore.build(data_mem, B, shard_budget=shard_budget,
                             pin_budget=pin_budget, device=device)
    n_rot = store.nshards - len(store.pinned_idx)
    TLOG(f"Rotating {n_rot}/{store.nshards} host-resident shards through "
         f"HBM ({len(store.pinned_idx)} pinned; {store.layout} layout, "
         f"~{store.shard_bytes(0) / 1e6:,.0f} MB/shard; dense "
         f"{dense_bytes / 1e6:,.0f} MB and ELL {ell_bytes / 1e6:,.0f} MB "
         f"both exceed MMVAE_DENSE_BYTES={budget / 1e6:,.0f} MB)")
    return RotatingBatches(store), covar, True


def train_vae_model(fast, recorder, data_block, covar_block, opt,
                    init_params: dict, device, start_epoch: int = 0,
                    init_opt_state: dict | None = None, on_epoch_end=None,
                    metrics_path: str | None = None, mesh=None
                    ) -> tuple[dict, list[float]]:
    """The training loop (reference mmvae_alg.hh:200-338):
    :func:`load_batches` picks and loads the tier (dense-resident, ELL,
    rotating shards or host streaming) and every epoch runs
    :class:`DenseEpochRunner` over it.

    ``init_opt_state`` is the named Adam state ``{count, mu, nu}``;
    ``on_epoch_end(epoch, params, opt_state, loss_vec)`` gets the named
    trees after every epoch (checkpointing).  Every ``.metrics.jsonl``
    row carries the JAX trainer's ``time_*`` host phase seconds
    (``time_step``, and ``time_record_submit`` on recording epochs);
    ``MMVAE_TRACE_DIR`` traces the training phase, each epoch under an
    ``ondevice_epoch`` (``host_epoch`` on the host-streaming tier)
    annotation.  Returns (trained params, per-epoch mean reported
    loss).

    With a :class:`~mmvae_tpu_torch.parallel.mesh.DataMesh` (JAX's
    ``host_count`` / ``host_id``) the blocks hold this rank's B / world
    rows of every global batch; each rank encodes its rows on a recording
    epoch, and rank 0 alone writes the metrics (the recorder and
    ``save_checkpoint`` keep their writes to rank 0 too); every rank
    returns the same parameters.  Under tensor parallelism ``fast`` is a
    :class:`Trainer` with ``tp_pspecs``, ``init_params`` and
    ``init_opt_state`` are this rank's shards, the blocks hold B / ndata
    rows (each rank keeps its block of the features), and the recorder,
    ``on_epoch_end`` and the caller get the full trees, gathered over the
    model row (every rank takes part)."""
    ntot = data_block.ntot()
    B = data_block.size()
    if ntot != covar_block.ntot() or B != covar_block.size():
        raise ValueError("data and covariate blocks differ in cells or "
                         "batch size")
    world = 1 if mesh is None else mesh.ndata
    primary = host_role()

    def full(tree):
        if mesh is None or not mesh.tp:
            return tree
        return gather_params(tree, fast.tp_pspecs, mesh)

    def full_opt(st):
        if mesh is None or not mesh.tp:
            return st
        return {"count": st["count"], "mu": full(st["mu"]),
                "nu": full(st["nu"])}

    batches = sequential_batches(ntot, B * world)
    TLOG(f"Batch size = {B}{f' x {world} processes' if world > 1 else ''}"
         f", Number of batches = {len(batches)}")

    source, covar, ondevice = load_batches(data_block, covar_block, opt,
                                           device, mesh)
    if torch.device(device).type == "cuda":
        from ..ops import _cuda

        _cuda.lib()  # build the kernels now, outside the epoch timing

    runner = DenseEpochRunner(
        fast, source, B * world, seed=opt.seed, covar=covar,
        covar_dim=covar_block.nfeature(),
        record_fn=recorder.encode if recorder is not None else None,
        mesh=mesh)
    q = fast.pack(init_params)
    po = (fast.pack_opt_state(init_opt_state) if init_opt_state is not None
          else fast.optimizer.init(q))
    kl = (fast.kl_max, fast.kl_min, fast.kl_discount)
    metrics = MetricsLogger(metrics_path if primary else None)
    timer = StepTimer()
    loss_vec: list[float] = []
    where = ", on-device" if ondevice else ""
    cells = runner.nbatch * B * world
    # a trace of the whole training phase when MMVAE_TRACE_DIR is set
    # (no-op otherwise)
    with trace():
        for epoch in range(start_epoch, opt.max_epoch):
            t0 = time.time()
            timer.reset()
            record_now = (recorder is not None
                          and (epoch + 1) % opt.recording == 0)
            # host time of the epoch's launches: the device runs on until
            # the loss fetch below, the one point where the JAX loop blocks
            with timer.phase("step"), annotate(
                    "ondevice_epoch" if ondevice else "host_epoch"):
                q, po, reps, enc = runner(q, po, epoch, record=record_now)
            epoch_loss = float(reps.cpu().numpy().mean())
            dt = time.time() - t0
            loss_vec.append(epoch_loss)
            TLOG(f"[{epoch + 1:>20}] {epoch_loss:>20.6f}"
                 f"  ({cells / dt:,.0f} cells/sec{where})")
            params = fast.unpack(q)
            if record_now:
                # after the epoch's clock: the port's recorder writes its
                # artifacts synchronously
                with timer.phase("record_submit"):
                    recorder.ingest(batches, enc, mesh)
                    recorder.update_on_epoch(full(params), epoch)
            metrics.log_epoch(
                epoch, loss=epoch_loss,
                kl_weight=float(kl_weight_schedule(epoch, *kl)),
                cells_per_sec=round(cells / dt, 1),
                **({"ondevice": True} if ondevice else {}),
                **{f"time_{k}": round(v, 4)
                   for k, v in timer.summary().items()})
            if on_epoch_end is not None:
                on_epoch_end(epoch, full(params),
                             full_opt(fast.unpack_opt_state(po)), loss_vec)
    TLOG("Done training")
    return full(fast.unpack(q)), loss_vec
