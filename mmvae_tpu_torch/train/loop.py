"""Training epochs, whole-dataset encoding sweeps, the resident matrix.

Ports of ``mmvae_tpu/train/loop.py`` (``_as_memory_block``,
``_build_dense``, the dense-resident branch of
``Trainer.make_ondevice_epoch`` and the single-device dense-resident path
of ``train_vae_model``) and of the two sweeps of
``mmvae_tpu/cli/encode.py``:

- :class:`DenseEpochRunner` / :func:`train_vae_model`: the (N, D) counts
  live on the device in their narrow integer dtype; each epoch walks the
  reference's sequential wrap-around batch schedule (a contiguous slice
  when N % B == 0) through a step — a packed fast step (any
  :class:`~mmvae_tpu_torch.ops.nb_fast.PackedFastStep`) or the generic
  :class:`Trainer` (``Trainer._batch_step`` on the named parameter tree)
  — with every random draw of the epoch made up front;
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
from ..data.pipeline import sequential_batches
from ..io import native
from ..ops.losses import kl_weight_schedule
from ..ops.nb_fast import (PackedAdam, batch_rand, draw_rand, tree_leaves,
                           tree_unflatten)
from ..utils.logging import TLOG
from ..utils.metrics import MetricsLogger
from ..utils.profiling import StepTimer, annotate, trace


def as_memory_block(block):
    """Coerce a data block to an in-memory (CSC) block."""
    if isinstance(block, MtxDataBlock):
        return MtxMemoryBlock(block.mtx_file, block.idx_file, block.B)
    return block


def build_dense(block, device: torch.device | str) -> torch.Tensor:
    """The (N, D) count matrix on ``device`` in the block's ``val_dtype``
    (int8, int16 or float32): filled on the host — the native one-pass
    fill when the C++ extension loads, a numpy scatter of the CSC arrays
    otherwise — then ONE host->device copy."""
    blk = as_memory_block(block)
    rows, vals, indptr = blk.csc_arrays()
    vd = np.dtype(getattr(blk, "val_dtype", np.float32))
    if native.available():
        TLOG("dense fill: native")
        host = native.dense_fill(rows, vals, indptr, blk.nfeature(), vd)
    else:
        TLOG("dense fill: numpy (native extension unavailable)")
        host = np.zeros((len(indptr) - 1, blk.nfeature()), vd)
        cols = np.repeat(np.arange(len(indptr) - 1), np.diff(indptr))
        host[cols, rows] = vals.astype(vd)
    return torch.from_numpy(host).to(device)


def encode_resident(model, params: dict, data: torch.Tensor, B: int,
                    chunk: int, prep: dict | None = None) -> tuple:
    """(N, width) outputs of the encoder — mean and log-variance, and
    the mixture's assignments — for every row of the device-resident
    ``data`` (N % B == 0), ``chunk`` batches per encoder call.  ``prep``
    is ``model.prepare_encoder``'s result (made here when None)."""
    N = data.shape[0]
    if N % B:
        raise ValueError(f"resident sweep needs N % B == 0 (N={N}, B={B})")
    if prep is None:
        prep = model.prepare_encoder(params)
    rows = max(1, chunk) * B
    outs = [model.encode_prepared(params, prep, data[lo:lo + rows])
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
    overdisp_latent)``).  Counts stay in their resident dtype."""

    def __init__(self, forward, loss_fn, opt, *, eps_widths,
                 kl=(1.0, 1e-2, 0.1), boot_loss_fn=None,
                 report_loss_override=None, boot_loss_override=None):
        self.forward, self.loss_fn = forward, loss_fn
        self.boot_loss_fn = boot_loss_fn if boot_loss_fn is not None \
            else loss_fn
        self._report_override = report_loss_override
        self._boot_override = boot_loss_override
        self.opt = opt
        self.kl_max, self.kl_min, self.kl_discount = kl
        self.eps_widths = tuple(eps_widths)
        self.optimizer = PackedAdam(opt.lr, opt.grad_clip, opt.weight_decay)
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
                   rand: dict):
        """The reporting loss (no update) and ``nboot`` bootstrap Adam
        steps, each on the resampled input rows ``x[ridx]``
        (mmvae_alg.hh:277-311).  Returns (params, opt_state, report)."""
        beta = self._beta_for(epoch_f, x.device)
        with torch.no_grad():
            report = self._report(params, x, c, rand["rep_eps"], beta)
        for i in range(self.opt.nboot):
            ridx = rand["ridx"][i]
            xb, cb = x.index_select(0, ridx), c.index_select(0, ridx)
            leaves = [v.detach().requires_grad_() for v in
                      tree_leaves(params)]
            loss = self._boot(tree_unflatten(params, leaves), xb, cb,
                              tuple(e[i] for e in rand["boot_eps"]), beta)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            # a leaf the loss does not reach has a zero gradient, as in JAX
            grads = [torch.zeros_like(v) if g is None else g
                     for g, v in zip(grads, leaves)]
            with torch.no_grad():
                params, opt_state = self.optimizer.update(
                    tree_unflatten(params, grads), opt_state, params)
        return params, opt_state, report


def epoch_generator(seed: int, epoch: int, device) -> torch.Generator:
    """The generator of one epoch's draws: a pure function of (seed,
    epoch), so a resumed run draws what the uninterrupted one drew."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) << 20) + int(epoch))
    return gen


class DenseEpochRunner:
    """One training epoch over device-resident counts (the dense branch
    of ``Trainer.make_ondevice_epoch``, train/loop.py:411-556).

    ``fast`` is a packed step or a :class:`Trainer`.
    The schedule is the reference's sequential wrap-around one
    (mmvae_alg.hh:261-266): batch b is rows (b*B + i) % N, a contiguous
    slice when N % B == 0.  The covariate is the all-ones column unless a
    dense (N, C) covariate matrix is given.  ``record_fn(params, x) ->
    (mean, lnvar[, extra])`` is evaluated right after each batch's
    updates on a recording epoch (the recorder's observation point,
    mmvae_alg.hh:315-317)."""

    def __init__(self, fast, data: torch.Tensor, B: int, seed: int = 0,
                 covar: torch.Tensor | None = None, covar_dim: int = 1,
                 record_fn=None):
        self.fast, self.data, self.B, self.seed = fast, data, B, seed
        self.covar, self.record_fn = covar, record_fn
        self.N = data.shape[0]
        self.nbatch = self.N // B + (1 if self.N % B else 0)
        self.device = data.device
        self.ones = torch.ones((B, covar_dim), dtype=torch.float32,
                               device=self.device)
        self.cols = (None if self.N % B == 0 else torch.from_numpy(
            np.stack(sequential_batches(self.N, B))).to(self.device))

    def draw(self, epoch: int) -> dict:
        return self.fast.draw_rand(
            epoch_generator(self.seed, epoch, self.device), self.nbatch,
            self.B)

    def _rows(self, b: int):
        if self.N % self.B == 0:
            sl = slice(b * self.B, (b + 1) * self.B)
            return self.data[sl], (self.ones if self.covar is None
                                   else self.covar[sl])
        cols = self.cols[b]
        return self.data.index_select(0, cols), (
            self.ones if self.covar is None
            else self.covar.index_select(0, cols))

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
        for b in range(self.nbatch):
            x, c = self._rows(b)
            q, opt_state, rep = self.fast.batch_step(
                q, opt_state, x, c, float(epoch), batch_rand(rand, b))
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


def train_vae_model(fast, recorder, data_block, covar_block, opt,
                    init_params: dict, device, start_epoch: int = 0,
                    init_opt_state: dict | None = None, on_epoch_end=None,
                    metrics_path: str | None = None
                    ) -> tuple[dict, list[float]]:
    """The training loop (reference mmvae_alg.hh:200-338) on the
    dense-resident path only: the counts are copied to ``device`` once
    and every epoch runs :class:`DenseEpochRunner`.

    ``init_opt_state`` is the named Adam state ``{count, mu, nu}``;
    ``on_epoch_end(epoch, params, opt_state, loss_vec)`` gets the named
    trees after every epoch (checkpointing).  Every ``.metrics.jsonl``
    row carries the JAX trainer's ``time_*`` host phase seconds
    (``time_step``, and ``time_record_submit`` on recording epochs);
    ``MMVAE_TRACE_DIR`` traces the training phase, each epoch under an
    ``ondevice_epoch`` annotation.  Returns (trained params, per-epoch
    mean reported loss)."""
    ntot = data_block.ntot()
    B = data_block.size()
    if ntot != covar_block.ntot() or B != covar_block.size():
        raise ValueError("data and covariate blocks differ in cells or "
                         "batch size")
    batches = sequential_batches(ntot, B)
    TLOG(f"Batch size = {B}, Number of batches = {len(batches)}")

    data_mem = as_memory_block(data_block)
    vd = np.dtype(getattr(data_mem, "val_dtype", np.float32))
    dense_bytes = ntot * data_mem.nfeature() * vd.itemsize
    budget = int(os.environ.get("MMVAE_DENSE_BYTES", 6 << 30))
    if not 0 < dense_bytes <= budget:
        raise NotImplementedError(
            f"the {vd.name} count matrix ({dense_bytes / 1e6:,.0f} MB) "
            f"exceeds MMVAE_DENSE_BYTES={budget / 1e6:,.0f} MB: training "
            f"beyond the dense-resident budget (ELL, rotation, host "
            f"streaming) is not ported yet (ROADMAP.md Queue 1 item 12)")
    TLOG(f"Loading data on device (dense-resident, "
         f"{dense_bytes / 1e6:,.0f} MB {vd.name})")
    data = build_dense(data_mem, device)
    covar = None
    if not getattr(covar_block, "auto_ones", False):
        covar = build_dense(covar_block, device).float()
    TLOG("Feature clustering is not applied (not ported yet, ROADMAP.md "
         "Queue 1 item 8): genes stay in input order")
    if torch.device(device).type == "cuda":
        from ..ops import _cuda

        _cuda.lib()  # build the kernels now, outside the epoch timing

    runner = DenseEpochRunner(
        fast, data, B, seed=opt.seed, covar=covar,
        covar_dim=covar_block.nfeature(),
        record_fn=recorder.encode if recorder is not None else None)
    q = fast.pack(init_params)
    po = (fast.pack_opt_state(init_opt_state) if init_opt_state is not None
          else fast.optimizer.init(q))
    kl = (fast.kl_max, fast.kl_min, fast.kl_discount)
    metrics = MetricsLogger(metrics_path)
    timer = StepTimer()
    loss_vec: list[float] = []
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
            with timer.phase("step"), annotate("ondevice_epoch"):
                q, po, reps, enc = runner(q, po, epoch, record=record_now)
            epoch_loss = float(reps.cpu().numpy().mean())
            dt = time.time() - t0
            loss_vec.append(epoch_loss)
            TLOG(f"[{epoch + 1:>20}] {epoch_loss:>20.6f}"
                 f"  ({runner.nbatch * B / dt:,.0f} cells/sec, on-device)")
            params = fast.unpack(q)
            if record_now:
                # after the epoch's clock: the port's recorder writes its
                # artifacts synchronously
                with timer.phase("record_submit"):
                    recorder.ingest(batches, enc)
                    recorder.update_on_epoch(params, epoch)
            metrics.log_epoch(
                epoch, loss=epoch_loss,
                kl_weight=float(kl_weight_schedule(epoch, *kl)),
                cells_per_sec=round(runner.nbatch * B / dt, 1),
                ondevice=True,
                **{f"time_{k}": round(v, 4)
                   for k, v in timer.summary().items()})
            if on_epoch_end is not None:
                on_epoch_end(epoch, params, fast.unpack_opt_state(po),
                             loss_vec)
    TLOG("Done training")
    return fast.unpack(q), loss_vec
