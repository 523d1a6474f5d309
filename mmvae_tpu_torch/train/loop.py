"""Training epochs, whole-dataset encoding sweeps, the resident matrix.

Ports of ``mmvae_tpu/train/loop.py`` (``_as_memory_block``,
``_build_dense``, ``_permute_d_axes``, ``Trainer.step``,
``can_step_record`` and ``step_record``, ``Trainer.make_ondevice_epoch``,
``Trainer.make_rotating_epoch``, ``train_vae_model``, ``visit_data`` and
``visit_vae_model``) and of the two sweeps of
``mmvae_tpu/cli/encode.py``:

- :class:`DenseEpochRunner` / :func:`train_vae_model`: each epoch walks
  the reference's sequential wrap-around batch schedule through a step —
  a packed fast step (any
  :class:`~mmvae_tpu_torch.ops.nb_fast.PackedFastStep`) or the generic
  :class:`Trainer` (``Trainer._batch_step`` on the named parameter tree)
  — with every random draw of the epoch made up front, ``--superbatch``
  S batch steps at a time: one CUDA graph replay on the card
  (:mod:`.superbatch`, JAX's ``lax.scan`` superbatch step), the same
  body eagerly on the CPU; ``Trainer.step`` / ``step_record`` are that
  step for custom loops.  The batches come
  from one of four tiers (:func:`load_batches`, JAX's choice): the
  (N, D) counts resident on the device in their narrow dtype; padded-ELL
  arrays on the device, densified a batch at a time
  (:class:`EllBatches`); host-resident shards rotated through the device
  (:class:`RotatingBatches`); or batches read from the file on the host
  (:class:`StreamedBatches`).  Every tier gives the same batches and
  draws, so the same bits.  On the dense-resident tier the genes may be
  reordered cold-first (:func:`cluster_features`, JAX's feature
  clustering); every tree that leaves the loop is in input order;
- :func:`encode_resident`: ``chunk`` batches of B rows go through the
  encoder per kernel launch (the encoder works row by row, and the
  mixture's per-batch noise is tiled over the chunk, so grouping changes
  no result);
- :func:`encode_streaming`: batches read from the out-of-core block in
  the reference's sequential wrap-around order, ``chunk`` batches per
  host->device copy;
- :func:`visit_data` / :func:`visit_vae_model`: whole-dataset sweeps of a
  visitor's ``update_on_batch`` over the same schedule.
"""

from __future__ import annotations

import contextlib
import os
import sys
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
                           superbatch_step, tree_leaves, tree_unflatten)
from ..parallel.collectives import pmean, psum
from ..parallel.mesh import gather_params
from ..parallel.multihost import host_role, sharded_batches
from ..utils.logging import TLOG
from ..utils.metrics import MetricsLogger
from ..utils.profiling import StepTimer, annotate, trace
from .superbatch import SuperbatchGraphs, superbatch_form, tree_map


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
    are clipped against the norm across the model row (:func:`tp_clip`).
    ``tp_record_encode(params, x)`` is then the model's TP record encoder
    on the shard (``tp_record_encoder``: (mean, lnvar) and, with
    ``tp_record_extra``, the extra output third), which
    :meth:`step_record` records with in place of the caller's encode, as
    JAX's ``tp_record_encode`` / ``tp_record_extra``."""

    def __init__(self, forward, loss_fn, opt, *, eps_widths,
                 kl=(1.0, 1e-2, 0.1), boot_loss_fn=None,
                 report_loss_override=None, boot_loss_override=None,
                 tp_pspecs=None, tp_record_encode=None,
                 tp_record_extra: bool = False):
        self.forward, self.loss_fn = forward, loss_fn
        self.boot_loss_fn = boot_loss_fn if boot_loss_fn is not None \
            else loss_fn
        self._report_override = report_loss_override
        self._boot_override = boot_loss_override
        self.opt = opt
        self.kl_max, self.kl_min, self.kl_discount = kl
        self.eps_widths = tuple(eps_widths)
        self.tp_pspecs = tp_pspecs
        self.tp_record_encode = tp_record_encode
        self.tp_record_extra = tp_record_extra
        self._tp_split = (None if tp_pspecs is None else
                          [a is not None for a in tree_leaves(tp_pspecs)])
        self.optimizer = PackedAdam(opt.lr, opt.grad_clip, opt.weight_decay,
                                    tp=tp_pspecs is not None)
        self._beta = None
        self.beta_override = None  # as the packed steps'
        self._sb: dict = {}
        self._draw = None  # (key, draws) of Trainer.step's last epoch

    @staticmethod
    def pack(t: dict) -> dict:
        return t

    unpack = pack_opt_state = unpack_opt_state = pack

    def draw_rand(self, gen: torch.Generator, nbatch: int, B: int) -> dict:
        return draw_rand(gen, nbatch, B, self.opt.nboot, self.eps_widths)

    def _beta_for(self, epoch_f: float, device) -> torch.Tensor:
        """As the packed steps' ``_beta_for``."""
        if self.beta_override is not None:
            return self.beta_override
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

    superbatch_step = superbatch_step

    # ------------------------------------------------------------------
    # the per-superbatch step for custom loops (JAX ``Trainer.step``,
    # ``can_step_record``, ``step_record``, train/loop.py:1031-1166)
    # ------------------------------------------------------------------
    def step(self, params: dict, opt_state: dict, x_sb, c_sb, epoch: int,
             batch_ids, rand: dict | None = None, *,
             nbatch: int | None = None, mesh=None):
        """Run one superbatch of sequential batches, the (S, B, D) counts
        ``x_sb`` (host or device; integer counts keep their dtype) and
        the (S, B, C) covariate ``c_sb``; returns (params, opt_state, the
        per-batch reported losses (S,)).  On a CUDA device the S batch
        steps are one CUDA graph replay, or a chain of segments around
        gloo collectives (:mod:`.superbatch`), captured at the first call
        of each size and kept by the trainer.

        ``rand`` is the superbatch's draws (``draw_rand``'s structure,
        leading axis S in ``batch_ids`` order; tests inject JAX's).
        Without it, ``nbatch`` is the epoch's number of batches and the
        draws are the rows ``batch_ids`` of the epoch's one draw
        (:func:`epoch_draws` of ``opt.seed`` and ``epoch``), the epoch
        runner's; the trainer keeps the last epoch's draw, so a loop that
        walks an epoch a superbatch at a time draws it once.  (JAX derives
        each batch's draws from its id alone; the port's epoch draw
        depends on the epoch's length, hence ``nbatch``.)

        ``mesh`` (a :class:`~mmvae_tpu_torch.parallel.mesh.DataMesh`, JAX's
        ``Trainer(mesh=...)``): ``x_sb`` and ``c_sb`` are this rank's
        M = B / ndata rows of each batch (under tensor parallelism its
        block of the features, and the parameters and Adam state its
        shards), ``rand`` the data index's draws under ``dp_shard`` and
        tensor parallelism and the global batch's under
        ``data_parallel``; every rank calls with the same ``batch_ids``.
        The step is ``batch_step(mesh=mesh)``, JAX's ``shard_map``
        superbatch step."""
        p, o, reps, _ = self._superbatch(params, opt_state, x_sb, c_sb,
                                         epoch, batch_ids, rand, nbatch,
                                         None, mesh)
        return p, o, reps

    def can_step_record(self, needs_extra: bool = False) -> bool:
        """Whether :meth:`step_record` is available (JAX's answer): always
        without tensor parallelism; under it when the trainer holds the
        model's TP record encoder (``tp_record_encode``) and, for an
        extra output, one that gives it (``tp_record_extra``)."""
        if self.tp_pspecs is None:
            return True
        return self.tp_record_encode is not None and (
            not needs_extra or self.tp_record_extra)

    def step_record(self, params: dict, opt_state: dict, x_sb, c_sb,
                    epoch: int, batch_ids, encode_fn, extra_fn=None,
                    rand: dict | None = None, *,
                    nbatch: int | None = None, mesh=None):
        """:meth:`step` that also returns each batch's posterior right
        after its updates (mmvae_alg.hh:315-317): (params, opt_state,
        (reports (S,), (mean, lnvar) each (S, B, width), extra)), extra
        the stacked ``extra_fn(params, x)`` outputs, else an
        ``encode_fn``'s third output (the mixture's assignments), else a
        zero a batch (S,), as JAX's scan returns it.  A recording epoch
        then costs one dispatch per superbatch, as a training epoch
        does.  Under tensor parallelism the trainer's
        ``tp_record_encode`` records on the shards in place of
        ``encode_fn`` (and gives the extra when ``extra_fn`` is asked
        for), as JAX swaps in its TP record functions; each rank gets
        its M rows' outputs."""
        if not self.can_step_record(extra_fn is not None):
            raise ValueError("step_record under tensor parallelism needs "
                             "the model's TP record encoder "
                             "(Trainer(tp_record_encode=...)"
                             + (", with tp_record_extra" if extra_fn
                                else "") + ")")
        if self.tp_pspecs is not None:
            record = (self.tp_record_encode, None,
                      3 if extra_fn is not None else 2)
        else:
            record = (encode_fn, extra_fn, None)
        p, o, reps, enc = self._superbatch(params, opt_state, x_sb, c_sb,
                                           epoch, batch_ids, rand, nbatch,
                                           record, mesh)
        extra = enc[2] if len(enc) > 2 else torch.zeros_like(reps)
        return p, o, (reps, (enc[0], enc[1]), extra)

    def _superbatch(self, params, opt_state, x_sb, c_sb, epoch, batch_ids,
                    rand, nbatch, record, mesh):
        dev = tree_leaves(params)[0].device
        x_sb = torch.as_tensor(x_sb, device=dev)
        c_sb = torch.as_tensor(c_sb, dtype=torch.float32, device=dev)
        ids = torch.as_tensor(np.asarray(batch_ids), dtype=torch.long,
                              device=dev)
        if rand is None:
            if nbatch is None:
                raise ValueError("Trainer.step needs the epoch's number of "
                                 "batches (nbatch=) or the draws (rand=)")
            if not 0 <= int(ids.min()) <= int(ids.max()) < nbatch:
                raise ValueError(f"batch ids {batch_ids} outside an epoch "
                                 f"of {nbatch} batches")
            B = x_sb.shape[1] * (1 if mesh is None else mesh.ndata)
            rand = tree_map(lambda t: t.index_select(0, ids),
                            self._epoch_draw(epoch, nbatch, B, dev, mesh))
        else:
            rand = tree_map(lambda t: t.to(dev), rand)
        sb = self._graphs_for(len(ids), record, mesh)
        sb.set_state(params, opt_state)
        sb.set_epoch(epoch)
        reps, enc = sb.run(sb.fill(x_sb, c_sb, rand), record is not None)
        p, o = sb.state()
        return p, o, reps.clone(), (None if enc is None
                                    else tuple(e.clone() for e in enc))

    def _epoch_draw(self, epoch: int, nbatch: int, B: int, dev,
                    mesh) -> dict:
        """The draws of an epoch of ``nbatch`` global batches of B (the
        epoch runner's, :func:`epoch_draws`), kept for the next call of
        the same epoch."""
        key = (self.opt.seed, int(epoch), int(nbatch), int(B), str(dev),
               None if mesh is None else (mesh.shard, mesh.data_index,
                                          mesh.ndata))
        if self._draw is None or self._draw[0] != key:
            self._draw = (key, epoch_draws(self, self.opt.seed, epoch,
                                           nbatch, B, dev, mesh))
        return self._draw[1]

    def _graphs_for(self, S: int, record, mesh) -> SuperbatchGraphs:
        """The trainer's graphs of one record triple (``(encode_fn,
        extra_fn, outputs kept)``, or None), kept by identity as JAX keeps
        its compiled record step, remade for a larger superbatch or
        another mesh."""
        sb = self._sb.get(record)
        if sb is None or sb.S < S or sb.mesh is not mesh:
            if sb is not None:
                sb.close()
            record_fn = None if record is None else _record_fn(*record)
            sb = self._sb[record] = SuperbatchGraphs(self, S, record_fn,
                                                     mesh=mesh)
        return sb

    def release_graphs(self) -> None:
        """Free the graphs :meth:`step` and :meth:`step_record` keep."""
        for sb in self._sb.values():
            sb.close()
        self._sb = {}


def _record_fn(encode_fn, extra_fn, keep=None):
    """``step_record``'s record outputs: (mean, lnvar[, extra]), the
    first ``keep`` of the encode's when given."""
    def record(params, x):
        with torch.no_grad():
            outs = tuple(encode_fn(params, x))
            if extra_fn is not None:
                outs = outs[:2] + (extra_fn(params, x),)
        return outs if keep is None else outs[:keep]
    return record


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


def epoch_draws(step, seed: int, epoch: int, nbatch: int, B: int, device,
                mesh=None) -> dict:
    """``step.draw_rand`` of an epoch of ``nbatch`` batches of B (the
    global batch under a mesh): from :func:`epoch_generator` of (seed,
    epoch), or under ``dp_shard`` and tensor parallelism of the data
    index too, for its own M = B / ndata rows."""
    if mesh is not None and mesh.shard:
        return step.draw_rand(
            epoch_generator(seed, epoch, device, mesh.data_index), nbatch,
            mesh.local_batch(B))
    return step.draw_rand(epoch_generator(seed, epoch, device), nbatch, B)


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


def grouped(batches, S: int):
    """Runs of up to S of the (x, c) pairs of ``batches`` as (list of x,
    list of c or None): the superbatches of the device tiers, whose
    batches are made one at a time.  On the rotating tier a shard's
    arrays reach the compute stream through ``ShardCopy.take`` (the wait
    on its copy, the allocator told of the use) before its batches are
    made, and a batch that is a view keeps its shard's memory alive
    until it is copied into the superbatch; a shard's end-of-compute
    event may be recorded before those copies, which only lets the next
    shard's copy start a superbatch early."""
    buf: list = []
    for item in batches:
        buf.append(item)
        if len(buf) == S:
            yield _unzip(buf)
            buf = []
    if buf:
        yield _unzip(buf)


def _unzip(buf: list):
    xs, cs = [x for x, _ in buf], [c for _, c in buf]
    return xs, None if cs[0] is None else cs


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
    page-locked memory: one batch at a time (:meth:`batches`) or S
    batches in one copy (:meth:`superbatches`, JAX's host path: a
    prefetch depth of 2S, the S batches stacked).  ``schedule`` is the
    cell ids of each batch (default
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

    def _host_stack(self, arrays: list, dtype=None) -> torch.Tensor:
        t = torch.from_numpy(np.stack(arrays))
        if dtype is not None:
            t = t.to(dtype)
        return t.pin_memory() if self.device.type == "cuda" else t

    def superbatches(self, S: int):
        """Runs of up to S batches as HOST tensors (s, B, D) and (s, B,
        C), page-locked on a CUDA device, for one host->device copy each
        into the superbatch buffers."""
        loader = PrefetchLoader(self.data_block, self.covar_block,
                                self.schedule, depth=2 * S)
        xs: list = []
        cs: list = []
        for _, x, c in loader:
            if self.features is not None:
                x = np.ascontiguousarray(x[:, self.features])
            xs.append(x)
            cs.append(c)
            if len(xs) == S:
                yield (self._host_stack(xs),
                       self._host_stack(cs, torch.float32))
                xs, cs = [], []
        if xs:
            yield self._host_stack(xs), self._host_stack(cs, torch.float32)


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
    ndata rows of each (a tensor ``data`` holds only those rows, batch
    after batch; under tensor parallelism only its block of the
    features); the draws (:meth:`draw`) are the global batch's under
    ``data_parallel`` and the data index's own M rows' under
    ``dp_shard`` and tensor parallelism, and ``record_fn`` sees the
    rank's rows (under tensor parallelism it is the model's TP record
    encoder, with its collectives).

    ``superbatch`` S (JAX's ``--superbatch``, default 8) walks the epoch
    in runs of S batches, the last one shorter when S does not divide
    the batches: each run is copied into the static inputs of a
    :class:`~mmvae_tpu_torch.train.superbatch.SuperbatchGraphs` and its S
    batch steps (with each batch's record outputs on a recording epoch)
    run as one CUDA graph replay (with a mesh on NCCL, its collectives
    inside), as a chain of segment replays around the host collectives
    (a mesh on gloo on a card), or eagerly on the CPU, with the same
    results as one batch at a time.  ``superbatch=None`` is that
    per-batch path itself, the reference the graphs are held against.
    :meth:`close` frees the graphs."""

    def __init__(self, fast, data, B: int, seed: int = 0,
                 covar: torch.Tensor | None = None, covar_dim: int = 1,
                 record_fn=None, mesh=None, superbatch: int | None = 8):
        self.fast, self.B, self.seed, self.mesh = fast, B, seed, mesh
        self.S = None if superbatch is None else max(1, int(superbatch))
        self.graphs = None
        self.graph_stats: dict = {}  # of the last graphs, kept by close
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
        """The epoch's draws (:func:`epoch_draws`): this rank's under a
        mesh."""
        return epoch_draws(self.fast, self.seed, epoch, self.nbatch, self.B,
                           self.device, self.mesh)

    def _covar(self, b: int) -> torch.Tensor:
        if self.covar is None:
            return self.ones
        if self.cols is None:
            return self.covar[b * self.B:(b + 1) * self.B]
        return self.covar.index_select(0, self.cols[b])

    def close(self) -> None:
        """Free the superbatch graphs (the runner makes them anew if
        called again)."""
        if self.graphs is not None:
            self.graphs.close()
            self.graphs = None

    def __call__(self, q: dict, opt_state: dict, epoch: int,
                 record: bool = False, rand: dict | None = None,
                 on_batch=None):
        """Run one epoch; returns (q, opt_state, reports (nbatch,), the
        record_fn outputs stacked to (nbatch, B, width) on a recording
        epoch, else None).  ``rand`` overrides the epoch's draws (tests
        feed the JAX package's); ``on_batch(b, report)`` is called after
        each batch's step (each superbatch's last batch with ``superbatch``
        S).  With ``superbatch`` S the epoch is timed from its first step
        to its last, the state's copy, into a row of ``graph_stats``
        (:class:`~mmvae_tpu_torch.train.superbatch.SuperbatchGraphs`)."""
        sb = None if self.S is None else self._graphs()
        if sb is not None:
            sb.begin_epoch(epoch, self.device)
        if rand is None:
            with annotate("epoch.draw"):
                rand = self.draw(epoch)
        if sb is not None:
            return self._superbatches(sb, q, opt_state, epoch, record, rand,
                                      on_batch)
        reps = torch.empty(self.nbatch, dtype=torch.float32,
                           device=self.device)
        enc = None
        for b, (x, c) in enumerate(self.source.batches()):
            c = self._covar(b) if c is None else c
            q, opt_state, rep = self.fast.batch_step(
                q, opt_state, x, c, float(epoch), batch_rand(rand, b),
                mesh=self.mesh)
            reps[b] = rep
            if on_batch is not None:
                on_batch(b, rep)
            if record:
                outs = self.record_fn(self.fast.unpack(q), x)
                if enc is None:
                    enc = tuple(torch.empty((self.nbatch, *t.shape),
                                            dtype=t.dtype, device=t.device)
                                for t in outs)
                for e, t in zip(enc, outs):
                    e[b] = t
        return q, opt_state, reps, enc

    def _graphs(self) -> SuperbatchGraphs:
        if self.graphs is None:
            self.graphs = SuperbatchGraphs(self.fast, self.S, self.record_fn,
                                           self.ones.shape[1], self.mesh)
            self.graph_stats = self.graphs.stats
        return self.graphs

    def _superbatches(self, sb, q, opt_state, epoch, record, rand,
                      on_batch):
        """The epoch in runs of S batches through the superbatch graphs
        ``sb``; returns what :meth:`__call__` returns, the state a copy
        of the static state."""
        sb.set_state(q, opt_state)
        sb.set_epoch(epoch)
        reps = torch.empty(self.nbatch, dtype=torch.float32,
                           device=self.device)
        enc, lo = None, 0
        src = self.source
        runs = (src.superbatches(self.S) if isinstance(src, StreamedBatches)
                else grouped(src.batches(), self.S))
        for xs, cs in runs:
            n = len(xs)
            if cs is None and self.covar is not None:
                cs = [self._covar(b) for b in range(lo, lo + n)]
            s = sb.fill(xs, cs, tree_map(lambda t: t[lo:lo + n], rand))
            r, e = sb.run(s, record)
            reps[lo:lo + s] = r
            if e is not None:
                if enc is None:
                    enc = tuple(torch.empty((self.nbatch, *t.shape[1:]),
                                            dtype=t.dtype, device=t.device)
                                for t in e)
                for a, t in zip(enc, e):
                    a[lo:lo + s] = t
            lo += s
            if on_batch is not None:
                on_batch(lo - 1, reps[lo - 1])
        with annotate("epoch.state"):
            q, opt_state = sb.state()
        sb.end_epoch()
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


def load_batches(data_block, covar_block, opt, device, mesh=None,
                 feature_perm: bool = False):
    """The tier of JAX's ``train_vae_model`` (train/loop.py:1276-1545)
    for these blocks and options, loaded: returns (source, dense
    covariate or None, on-device?, gene permutation or None), the source
    being the (N, D) tensor of the dense-resident tier or the batch
    source of another tier, each logged with JAX's line.  A
    data-parallel or tensor-parallel rank (``mesh``) takes
    :func:`load_dp_batches` and never permutes.  With ``feature_perm``
    the dense-resident matrix may come back with its genes reordered
    (:func:`cluster_features`); the permutation is then returned.

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
        return (*load_dp_batches(data_block, covar_block, opt, device, mesh),
                None)
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
        return (StreamedBatches(data_block, covar_block, B, device), None,
                False, None)

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
        data, perm = build_dense(data_mem, device), None
        if feature_perm:
            data, perm = cluster_features(data, covar_block.nfeature())
        return data, covar, True, perm
    if 0 < ell_bytes <= budget or os.environ.get("MMVAE_ROTATE", "1") == "0":
        TLOG("Loading data on device (ELL layout)")
        csc = DeviceCSC.from_memory_block(data_mem, count_dtype="auto",
                                          device=device)
        return EllBatches(csc, B), covar, True, None
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
    return RotatingBatches(store), covar, True, None


def cluster_features(data: torch.Tensor, covar_dim: int
                     ) -> tuple[torch.Tensor, np.ndarray | None]:
    """JAX's feature clustering (train/loop.py:1442-1490) of the
    dense-resident (N, D) counts: (counts, None) unchanged, or (the
    counts with their genes reordered cold-first, that order).

    The step kernels (K2, K6, K3 and the ELBO kernels) choose their
    lgamma regime per 64-column tile over all B rows, and a tile whose
    counts are all integers <= 7 takes the exact select-product path; a
    few hot genes (a count > 7) scattered over the genes make every tile
    they touch pay the slower one.  Moving them to the tail confines them
    to the last tiles.  It engages, with JAX's gates, when
    ``MMVAE_FEATURE_PERM`` is not ``"0"``, the covariate's width is not D
    (every axis of size D is permuted, :func:`permute_d_axes`), the
    kernels run (a CUDA tensor and D >= 512, JAX's ``_use_kernel``) or
    ``MMVAE_FEATURE_PERM=force``, and some gene but no more than half of
    them is hot.  The order is JAX's ``argsort(hot, kind="stable")``.
    The unpermuted matrix is freed when the caller drops it (two copies
    exist only inside this call)."""
    D = data.shape[1]
    env = os.environ.get("MMVAE_FEATURE_PERM", "1")
    if env == "0" or covar_dim == D:
        return data, None
    if not (env == "force" or (data.device.type == "cuda" and D >= 512)):
        return data, None
    with annotate("cluster_features"):
        hot = hot_genes(data)
        frac = float(hot.mean())
        if not hot.any() or frac > 0.5:
            return data, None
        perm = np.argsort(hot, kind="stable")
        data = data.index_select(1, torch.from_numpy(perm).to(data.device))
    TLOG(f"Feature clustering: {int(hot.sum())} hot genes (count>7, "
         f"{100 * frac:.1f}%) moved to the tail lane tiles (artifacts stay "
         f"in input order; MMVAE_FEATURE_PERM=0 to disable)")
    return data, perm


def hot_genes(data: torch.Tensor) -> np.ndarray:
    """(D,) bool: the genes of the (N, D) counts with a count above 7, the
    select-product regime's limit (``gmax > 7``, JAX's rule)."""
    return (torch.amax(data, 0) > 7).cpu().numpy()


def permute_d_axes(tree, perm, D: int):
    """``tree`` with every axis of size ``D`` of every tensor leaf
    gathered by ``perm`` (``index_select``); dicts, lists and tuples are
    walked, other leaves pass through.  JAX's ``_permute_d_axes``
    (train/loop.py:1819-1837): D >= 512 under the clustering gate, which
    no latent, hidden or component width of the reference reaches, and
    the gate skips a covariate of width D.  ``argsort(perm)`` undoes
    it."""
    if isinstance(tree, dict):
        return {k: permute_d_axes(v, perm, D) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(permute_d_axes(v, perm, D) for v in tree)
    if not isinstance(tree, torch.Tensor):
        return tree
    idx = torch.as_tensor(np.asarray(perm), device=tree.device)
    for ax, s in enumerate(tree.shape):
        if s == D:
            tree = tree.index_select(ax, idx)
    return tree


@trace()  # MMVAE_TRACE_DIR: one trace of the call, its set-up included
def train_vae_model(fast, recorder, data_block, covar_block, opt,
                    init_params: dict, device, start_epoch: int = 0,
                    init_opt_state: dict | None = None, on_epoch_end=None,
                    metrics_path: str | None = None, mesh=None,
                    feature_perm: bool = False, feature_perm_apply=None
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
    annotation.  A recording epoch hands its posteriors and parameters
    to ``recorder.submit_epoch`` inside the epoch's clock, after the
    epoch's loss fetch; the recorder's pending writes are joined (and
    their errors raised) before this returns or propagates an exception.
    On the host-streaming tier, when stderr is a terminal, rank 0 shows
    the reference's live ``\r[batch] loss`` line, at most about once a
    second (reading the loss waits for the device).  Returns (trained
    params, per-epoch mean reported loss).

    ``feature_perm`` lets the dense-resident tier reorder the genes
    (:func:`cluster_features`, JAX's ``feature_perm``): the parameters
    and the Adam state (a resumed one is in input order) are permuted
    with the counts on entry, and every tree that leaves — the
    recorder's parameters, ``on_epoch_end``'s trees and the return value
    — is permuted back, so the outside sees input gene order only.
    ``feature_perm_apply(order)`` then permutes a model's D-indexed
    constants outside the parameters (the mixture's annotation): it is
    called with the order on entry and with its inverse on the way out.

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
    D = data_block.nfeature()

    batches = sequential_batches(ntot, B * world)
    TLOG(f"Batch size = {B}{f' x {world} processes' if world > 1 else ''}"
         f", Number of batches = {len(batches)}")

    source, covar, ondevice, perm = load_batches(
        data_block, covar_block, opt, device, mesh, feature_perm)
    inv = None if perm is None else np.argsort(perm)

    def full(tree):
        """A tree as the outside sees it: gathered over the model row
        under tensor parallelism, in input gene order when clustered."""
        if inv is not None:
            return permute_d_axes(tree, inv, D)
        if mesh is None or not mesh.tp:
            return tree
        return gather_params(tree, fast.tp_pspecs, mesh)

    def full_opt(st):
        return {"count": st["count"], "mu": full(st["mu"]),
                "nu": full(st["nu"])}

    if perm is not None:
        init_params = permute_d_axes(init_params, perm, D)
        if init_opt_state is not None:
            init_opt_state = permute_d_axes(init_opt_state, perm, D)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        from ..ops import _cuda

        _cuda.lib()  # build the kernels now, outside the epoch timing

    S = max(1, int(opt.superbatch))
    if primary:
        how = {"eager": "a dispatch (eager on the CPU)",
               "graph": "a CUDA graph replay" + ("" if mesh is None
                                                 else " (NCCL inside)"),
               "segments": "a chain of CUDA graph segments around gloo "
                           "collectives"}[superbatch_form(mesh, device)]
        TLOG(f"Superbatch: {S} batch steps {how}")
    runner = DenseEpochRunner(
        fast, source, B * world, seed=opt.seed, covar=covar,
        covar_dim=covar_block.nfeature(),
        record_fn=recorder.encode if recorder is not None else None,
        mesh=mesh, superbatch=S)
    q = fast.pack(init_params)
    po = (fast.pack_opt_state(init_opt_state) if init_opt_state is not None
          else fast.optimizer.init(q))
    kl = (fast.kl_max, fast.kl_min, fast.kl_discount)
    metrics = MetricsLogger(metrics_path if primary else None)
    timer = StepTimer()
    loss_vec: list[float] = []
    where = ", on-device" if ondevice else ""
    cells = runner.nbatch * B * world
    shown = [0.0]  # when the live batch line was last written

    def show(b, rep):
        now = time.monotonic()
        if now - shown[0] >= 1.0:
            sys.stderr.write(f"\r[{b + 1:>20}] {float(rep):>20.6f}")
            shown[0] = now

    live = (primary and isinstance(source, StreamedBatches)
            and sys.stderr.isatty())
    # on the way out, in this order: the recorder's pending writes, the
    # model's constants back in input order
    with contextlib.ExitStack() as stack:
        if perm is not None and feature_perm_apply is not None:
            feature_perm_apply(perm)
            stack.callback(feature_perm_apply, inv)
        if recorder is not None:
            stack.callback(recorder.flush)
        # first on the way out: no graph outlives the device constants
        # it reads (the mixture's masks go back to input order above)
        stack.callback(runner.close)
        for epoch in range(start_epoch, opt.max_epoch):
            t0 = time.time()
            timer.reset()
            shown[0] = 0.0
            record_now = (recorder is not None
                          and (epoch + 1) % opt.recording == 0)
            # host time of the epoch's launches: the device runs on until
            # the loss fetch below, the one point where the JAX loop blocks
            with timer.phase("step"), annotate(
                    "ondevice_epoch" if ondevice else "host_epoch"):
                q, po, reps, enc = runner(q, po, epoch, record=record_now,
                                          on_batch=show if live else None)
            epoch_loss = float(reps.cpu().numpy().mean())
            if live:
                sys.stderr.write("\r")  # clear the batch line
            if record_now:
                # the device copies here; the scatter and the writes on
                # the recorder's writer thread
                with timer.phase("record_submit"):
                    recorder.submit_epoch(batches, enc,
                                          full(fast.unpack(q)), epoch, mesh)
            dt = time.time() - t0
            loss_vec.append(epoch_loss)
            TLOG(f"[{epoch + 1:>20}] {epoch_loss:>20.6f}"
                 f"  ({cells / dt:,.0f} cells/sec{where})")
            metrics.log_epoch(
                epoch, loss=epoch_loss,
                kl_weight=float(kl_weight_schedule(epoch, *kl)),
                cells_per_sec=round(cells / dt, 1),
                **({"ondevice": True} if ondevice else {}),
                **{f"time_{k}": round(v, 4)
                   for k, v in timer.summary().items()})
            if on_epoch_end is not None:
                on_epoch_end(epoch, full(fast.unpack(q)),
                             full_opt(fast.unpack_opt_state(po)), loss_vec)
    st = runner.graph_stats
    if st.get("captures"):
        rows = st["epochs"]
        TLOG(f"Superbatch graphs: {st['captures']} captured in "
             f"{st['capture_s']:.2f}s ({st['capture_warm_s']:.2f}s of "
             f"warm-up, {st['capture_graph_s']:.2f}s of capture), "
             f"{st['pool_bytes'] / 1e6:,.1f} MB reserved, "
             f"{st['replays']} replays"
             + (f"; {st['segments']} segments and {st['host_collectives']} "
                f"host collectives a superbatch of {st['segments_of']}"
                if st["form"] == "segments" else "")
             + (f"; device {_ms_a_batch(rows[0]):.3f} ms a batch in epoch "
                f"{rows[0]['epoch'] + 1}, {_ms_a_batch(rows[-1]):.3f} in "
                f"epoch {rows[-1]['epoch'] + 1}, "
                f"{100 * _outside_replays(rows[-1]):.2f}% of its time "
                f"outside replays" if rows else "")
             + (f"; {st['rows_dropped']} epochs untimed (events pending "
                f"when read)" if st["rows_dropped"] else ""))
    TLOG("Done training")
    return full(fast.unpack(q)), loss_vec


def _ms_a_batch(row: dict) -> float:
    """Device milliseconds a batch in the replays of an epoch row of
    ``SuperbatchGraphs.stats["epochs"]``."""
    return 1e3 * row["replay_s"] / row["batches"]


def _outside_replays(row: dict) -> float:
    """The share of an epoch row's device time, the epoch boundary
    before it included, spent outside replays."""
    return 1.0 - row["replay_s"] / (row["span_s"] + (row["lead_s"] or 0.0))


def visit_data(visitor, data_block) -> None:
    """Model-free whole-dataset sweep (JAX ``visit_data``,
    train/loop.py:1889-1902; reference mmvae_alg.hh:127-160): each batch
    of the sequential wrap-around schedule is read from the block and
    handed to ``visitor.update_on_batch(x, batch)`` (x a host array)."""
    ntot, B = data_block.ntot(), data_block.size()
    batches = sequential_batches(ntot, B)
    TLOG(f"Batch size = {B}, Number of batches = {len(batches)}")
    for batch in batches:
        data_block.clear()
        visitor.update_on_batch(data_block.read(batch), batch)
    TLOG("Done visit")


def visit_vae_model(encode_fn, params, visitor, data_block) -> None:
    """Whole-dataset sweep without training (JAX ``visit_vae_model``,
    train/loop.py:1905-1916; reference mmvae_alg.hh:162-198):
    ``visitor.update_on_batch(params, x, batch)`` for each batch of the
    sequential wrap-around schedule, as
    :meth:`~mmvae_tpu_torch.train.recorder.LatentRecorder.update_on_batch`
    takes it.  ``encode_fn`` is unused, as in JAX: the visitor encodes."""
    del encode_fn
    ntot, B = data_block.ntot(), data_block.size()
    batches = sequential_batches(ntot, B)
    TLOG(f"Batch size = {B}, Number of batches = {len(batches)}")
    for batch in batches:
        data_block.clear()
        visitor.update_on_batch(params, data_block.read(batch), batch)
    TLOG("Done visit")
