"""Shared CLI scaffolding of the port's trainers: one parser over the
option groups, the data-parallel and tensor-parallel set-up, index
auto-build and covariate auto-creation, and the run itself (resume,
checkpoints, recording, scores).

Port of the JAX-free part of ``mmvae_tpu/cli/common.py`` (that module
loads JAX at import), mirroring the setup phase of the reference mains
(src/nb_vae_main.cc:51-82).  A trainer's main runs::

    device = resolve_device(ns.device)
    device = topt.apply_runtime_config(device)   # the process group
    local_b, mesh = multihost_setup(opts, topt, device, fusable)
    data_block, covar_block = prepare_blocks(opts, local_batch=local_b)
    ...
    run_training(..., device, mesh=mesh)

In a multi-process run only rank 0 writes: the index, the covariate
file, the artifacts, the metrics, the checkpoints and ``scores.gz``.
"""

from __future__ import annotations

import argparse
import os

import torch

from ..data.block import MtxDataBlock, MtxMemoryBlock, create_ones_like
from ..io.index import build_mmutil_index
import torch.distributed as dist

from ..io.mtx import peek_mtx_header
from ..io.writers import write_vector_file
from ..models.nb import adam_from_numpy, params_from_numpy
from ..parallel.mesh import make_mesh, shard_params
from ..parallel.multihost import barrier, host_role
from ..train.checkpoint import load_checkpoint, load_opt_state, save_checkpoint
from ..train.config import MMVaeOptions, TrainingOptions
from ..train.loop import Trainer, train_vae_model
from ..train.recorder import LatentRecorder, latent_names
from ..utils.logging import ELOG, TLOG, WLOG
from ..utils.summary import pretty_print

# auto data mode: hold the CSC arrays in host RAM below this estimate
_INMEM_BYTES = int(os.environ.get("MMVAE_INMEM_BYTES", 4 << 30))


def compose_parsers(description: str, model_group) -> argparse.ArgumentParser:
    """One argparse parser carrying all three option groups."""
    p = argparse.ArgumentParser(
        description=description,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    MMVaeOptions.add_args(p)
    TrainingOptions.add_args(p)
    model_group(p.add_argument_group("model"))
    return p


def warn_unknown_args(unknown) -> None:
    """Warn about flags no option group claims (the reference parses
    tolerantly; a leftover flag is most likely a typo)."""
    if unknown:
        WLOG("ignoring unrecognized arguments:", " ".join(unknown))


def add_relu_flags(g) -> None:
    g.add_argument("--relu", dest="do_relu", action="store_true",
                   default=False)
    g.add_argument("--no_relu", "--no-relu", dest="do_relu",
                   action="store_false")


def _pick_block_type(opts: MMVaeOptions):
    """Streaming vs in-memory data block (``--data_mode``); batch
    contents are identical either way."""
    if opts.data_mode == "stream":
        return MtxDataBlock
    if opts.data_mode == "memory":
        return MtxMemoryBlock
    hdr = peek_mtx_header(opts.mtx)
    est = hdr.nnz * 8 + (hdr.cols + 1) * 8
    if est <= _INMEM_BYTES:
        TLOG(f"Data fits in memory (~{est / 1e6:,.0f} MB) — "
             "using the in-memory block (--data_mode stream to override)")
        return MtxMemoryBlock
    return MtxDataBlock


def multihost_setup(opts: MMVaeOptions, topt: TrainingOptions, device,
                    fusable: bool | None = None
                    ) -> tuple[int | None, object]:
    """(local batch or None, :class:`~mmvae_tpu_torch.parallel.mesh.DataMesh`
    or None) of the run (JAX ``cli/common.py:111-125``).

    After :meth:`TrainingOptions.apply_runtime_config` started a process
    group of world > 1, each rank reads B / world rows of every global
    batch and trains data-parallel: ``--dp_shard`` semantics with that
    flag, ``--data_parallel`` ones otherwise (JAX ``cli/nb_vae.py:
    137-140``).  ``--data_parallel`` or ``--dp_shard`` in a world of one
    process is logged and trains the single-device step.

    ``--tensor_parallel N`` > 1 wins over both (JAX ``cli/nb_vae.py:
    114-140``): the world forms a (W / N, N) grid, each rank reads
    B / (W / N) rows of every batch and keeps its D / N features.  It
    raises JAX's errors when N does not divide the feature dim D and,
    where the trainer needs it (``fusable`` not None), when the step is
    not the fused direct-decoder path; and, where JAX's ``make_mesh``
    asserts, when N does not divide the world, naming the flags that
    start ranks."""
    tp = max(1, topt.tensor_parallel)
    if tp > 1:
        return _tp_setup(opts, tp, device, fusable)
    mode = "dp_shard" if topt.dp_shard else "data_parallel"
    mesh = make_mesh(device, mode)
    if mesh is None:
        if topt.data_parallel or topt.dp_shard:
            TLOG(f"--{mode}: one process, so the single-device step "
                 "(start one process a device with --num_hosts, --host_id "
                 "and --coordinator to train data-parallel)")
        return None, None
    M = mesh.local_batch(opts.batch_size)  # B must divide: raises
    TLOG(f"Data-parallel ({mode}) over {mesh.world} processes: rank "
         f"{mesh.rank} on {mesh.device}, {M} rows of every batch of "
         f"{opts.batch_size}")
    return M, mesh


def _tp_setup(opts: MMVaeOptions, tp: int, device, fusable):
    D = peek_mtx_header(opts.mtx).rows
    if D % tp:
        raise ValueError(f"--tensor_parallel {tp} must divide the feature "
                         f"dim {D}")
    if fusable is not None and not fusable:
        raise ValueError("--tensor_parallel needs the fused step path "
                         "(direct mu decoder, --fused_step)")
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world % tp:
        raise ValueError(f"--tensor_parallel {tp} does not divide the "
                         f"{world} processes: start a multiple of {tp} ranks "
                         f"with --num_hosts, --host_id and --coordinator")
    mesh = make_mesh(device, "dp_shard", tp)
    M = mesh.local_batch(opts.batch_size)  # B must divide: raises
    cols = mesh.local_cols(D)
    TLOG(f"Tensor-parallel over (data={mesh.ndata}, model={tp}) processes: "
         f"rank {mesh.rank} at data index {mesh.data_index}, model index "
         f"{mesh.model_index} on {mesh.device}, {M} rows of every batch of "
         f"{opts.batch_size}, features [{cols.start}, {cols.stop}) of {D}")
    return M, mesh


def prepare_blocks(opts: MMVaeOptions, local_batch: int | None = None):
    """Build indexes as needed and construct the data and covariate
    blocks (reference src/nb_vae_main.cc:58-82); without ``--covar`` an
    all-ones 1 x N covariate is written next to the output and flagged
    ``auto_ones``.  ``local_batch`` overrides the blocks' batch size (a
    rank reads B / world rows of every batch); in a multi-process run
    rank 0 alone writes the index and the covariate files, and the
    others wait for them at a barrier (JAX ``cli/common.py:136-190``)."""
    B = local_batch if local_batch is not None else opts.batch_size
    primary = host_role()
    if primary and not os.path.exists(opts.idx):
        build_mmutil_index(opts.mtx, opts.idx)
    barrier()
    block_type = _pick_block_type(opts)
    if block_type is MtxMemoryBlock:
        data_block = block_type(opts.mtx, opts.idx, B, count_dtype="auto")
    else:
        data_block = block_type(opts.mtx, opts.idx, B)

    covar_mtx, covar_idx = opts.covar_mtx, opts.covar_idx
    auto_covar = not covar_mtx or not os.path.exists(covar_mtx)
    if auto_covar:
        covar_mtx = opts.out + ".covar.mtx.gz"
        covar_idx = covar_mtx + ".index"
        if primary:
            create_ones_like(data_block, covar_mtx)
            TLOG("No covariate file is given. So we use this:", covar_mtx)
            if os.path.exists(covar_idx):
                os.remove(covar_idx)
            build_mmutil_index(covar_mtx, covar_idx)
    elif primary and not os.path.exists(covar_idx):
        build_mmutil_index(covar_mtx, covar_idx)
    barrier()
    covar_block = block_type(covar_mtx, covar_idx, B)
    if auto_covar:
        covar_block.auto_ones = True
    return data_block, covar_block


def add_device_flag(g) -> None:
    g.add_argument("--device", default="cuda",
                   help="torch device of the run; 'cuda' needs a GPU "
                        "(never falls back to the CPU)")


def tp_trainer(model, topt: TrainingOptions, kl, eps_widths, report,
               boot) -> Trainer:
    """The tensor-parallel generic ``Trainer`` of ``model`` (JAX's
    ``tp_shard_map`` Trainer): the ``report`` and ``boot`` losses on the
    shard, the model's ``tp_pspecs`` for the clip across the model row."""
    specs = model.tp_pspecs(model.init(torch.Generator().manual_seed(0)))
    return Trainer(None, None, topt, kl=kl, eps_widths=eps_widths,
                   report_loss_override=report, boot_loss_override=boot,
                   tp_pspecs=specs)


def resolve_device(name: str) -> torch.device | None:
    """The run's device with TF32 switched off (full float32 matmuls), or
    None, logged, when it is CUDA and no card is available."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        ELOG(f"--device {name}: no CUDA device is available; pass "
             f"--device cpu to run on the CPU")
        return None
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return device


def run_training(opts: MMVaeOptions, topt: TrainingOptions, model, fast,
                 data_block, covar_block, device, mesh=None,
                 feature_perm: bool = False, feature_perm_apply=None) -> int:
    """Initialise (or ``--resume``) the parameters and the Adam state,
    print the model summary to stderr, train the step (packed or generic)
    on the data tier :func:`~mmvae_tpu_torch.train.loop.load_batches`
    picks, with recording and checkpoints, and write
    ``${out}.scores.gz``.  The recorder's encode and its extra artifact
    come from ``model.record_encoder``, its posterior artifacts' names
    from :func:`~mmvae_tpu_torch.train.recorder.latent_names`.  Under a
    ``mesh`` every rank initialises (or resumes) the same parameters and
    rank 0 alone writes.  Under tensor parallelism each rank then keeps
    its shard of the parameters and of the Adam state (``fast`` is the
    TP ``Trainer``), the recorder encodes with the model's
    ``tp_record_encoder``, and the checkpoints hold the full arrays in
    the tensor-parallel chain's layout.  The recorder writes on its
    background thread (``async_writes``, as the JAX CLIs set it);
    ``feature_perm`` and ``feature_perm_apply`` go to
    :func:`~mmvae_tpu_torch.train.loop.train_vae_model` (the NB and vMF+NB
    trainers cluster features, as their JAX CLIs do)."""
    params = model.init(torch.Generator().manual_seed(topt.seed),
                        device=device)
    B = opts.batch_size
    tp = mesh is not None and mesh.tp
    rows = None if mesh is None else mesh.rows(B)
    if tp:
        encode_fn, extra_name = model.tp_record_encoder(
            topt.seed, B, rows, mesh.model_group)
    else:
        encode_fn, extra_name = model.record_encoder(topt.seed, B, rows=rows)
    mean_name, lnvar_name = latent_names(model)
    recorder = LatentRecorder(opts.out, topt.max_epoch, data_block.ntot(),
                              encode_fn=encode_fn, extra_name=extra_name,
                              mean_name=mean_name, lnvar_name=lnvar_name,
                              async_writes=True)
    start_epoch, init_opt_state, prev_losses = 0, None, []
    if topt.resume:
        params_np, start_epoch, prev_losses = load_checkpoint(topt.resume,
                                                              model)
        params = params_from_numpy(params_np, device)
        init_opt_state = adam_from_numpy(
            load_opt_state(topt.resume, model, tp=tp), device)
        TLOG(f"Resumed from {topt.resume} at epoch {start_epoch}")

    def on_epoch_end(epoch, p, o, losses):
        save_checkpoint(topt.checkpoint_dir, p, epoch, topt.seed,
                        prev_losses + losses, opt_state=o, tp=tp)

    primary = host_role()
    TLOG("Training the model...")
    if primary:
        # reference parity: model->pretty_print(std::cerr) at train start
        # (mmvae_alg.hh:238), where both JAX trainer CLIs print it
        pretty_print(model, params)
    if tp:
        params = shard_params(params, fast.tp_pspecs, mesh)
        if init_opt_state is not None:
            init_opt_state = {
                "count": init_opt_state["count"],
                **{m: shard_params(init_opt_state[m], fast.tp_pspecs, mesh)
                   for m in ("mu", "nu")}}
    params, scores = train_vae_model(
        fast, recorder, data_block, covar_block, topt, params, device,
        start_epoch=start_epoch, init_opt_state=init_opt_state,
        on_epoch_end=on_epoch_end if topt.checkpoint_dir else None,
        metrics_path=opts.out + ".metrics.jsonl", mesh=mesh,
        feature_perm=feature_perm, feature_perm_apply=feature_perm_apply)
    if primary:
        write_vector_file(opts.out + ".scores.gz", prev_losses + scores)
    TLOG("Done")
    return 0
