#!/usr/bin/env python3
"""Drive the PyTorch port (``mmvae_tpu_torch``) once on one CUDA card.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises, and the script
exits non-zero without the final line):

0. device: require CUDA; print the card's name and power limit
   (``nvidia-smi``), which tag every number printed after it;
1. build: compile every kernel of the port from ``mmvae_tpu_torch/csrc``
   with nvcc for sm_90a; the registers and spills of every
   ``count_encode``, ``nb_valgrad``, ``count_encode_bwd``, ``nb_lse``,
   ``nb_value``, ``nb_finish`` and ``nb_elbo`` instance, failing if one
   spills;
2. kernel against plain: ``count_encode`` on the card against its plain
   PyTorch version at the NB trainer's launch (M = 100, 2 + 2 rows), the
   serving launch (M = 1600, 2 + 0), a data-parallel rank's launches
   (M = 50, 2 + 2 and 2 + 0) and ragged and wide cases, with times;
3. grouping and storage invariance of the three forward instances (K4,
   K4s, K4f with the marker filter of phase 14), bitwise: one launch over
   1600 rows == 16 of 100 == a ragged split (1 + 37 + 62 + 15 x 100);
   int8 == int16 == float32 storage of the same counts; two runs;
4. the serving CLI end to end (the main path) on a synthetic
   4000 x 20000 matrix and a random D=20000 NB-VAE checkpoint, resident
   and streaming;
5. full-size serving sweep: 100,000 x 20,000 int8 counts on the card,
   through the NB encoder and through the vMF-VAE's (cells/sec, device
   busy and idle share);
6. training kernels against plain: K5 (``count_encode`` backward), K1
   (``lse``), K6 (``value``), K2 (``valgrad``) and K3 (``finish``) on the
   card against their plain PyTorch versions at B = 100, D = 20,000 in
   the three lgamma regimes (all counts <= 7, integer counts, non-integer
   float32) and at a ragged D = 1,003, with device times;
7. one batch step: the kernel route of the packed step against its plain
   route on the card, with the same random draws;
8. the trainer CLI end to end (the training main path): ``nb_vae`` on
   phase 4's synthetic matrix for 2 epochs with recording and a
   checkpoint, every kernel's launch count > 0, the genes clustered
   (phase 42), then ``--resume`` for one more epoch;
9. full-width training: two epochs of the dense-resident epoch runner
   over the first 40,000 of phase 5's 100,000 x 20,000 int8 counts (a
   depth cut for the time limit), with a profile of 20 batches;
10. the joint vMF+NB model's kernel variants against their plain
    versions: ``count_encode`` with row stats (a training batch, 5 + 3
    rows, the serving launch, 2 + 0 rows, a data-parallel rank's 50 rows,
    and 37 rows at D = 1,003 and at the forward tile's edges D = 255,
    256, 257), its backward (K5) at
    the 5 + 3 rows, ``value`` and ``valgrad``
    with ``pb`` and exp-nu in phase 6's regimes, with elements at the
    NU_HI clamp;
11. one joint batch step, kernel route against plain route;
12. the joint trainer CLI end to end (its main path): ``vmfnb_vae`` on
    phase 4's matrix for 2 epochs with recording and a checkpoint, every
    kernel of the path launched, ``--resume`` for one more epoch; then
    ``encode --model vmfnb`` on that checkpoint, resident and streaming
    (bitwise equal), against the plain unfolded encoder;
13. full-width joint training: two epochs over the first 10,000 of phase
    5's counts, with a profile of 20 batches;
14. the labeled mixture's kernel instance K4f (``count_encode`` with the
    annotation-filtered row stats) against its plain version, with a
    marker-gene mask (10 components of 200 genes from seed 0, ~90% of the
    genes outside it): the training launch (B = 100, 12 + 3 rows) in
    int8, int16 and float32 counts, the serving launch (M = 1600,
    12 + 1 rows), a two-launch case (22 + 3 rows), a data-parallel
    rank's 50 rows and 37 rows at
    D = 1,003, 255, 256 and 257 (the mask's first D genes); bitwise
    repeatability, 1 launch == 16 launches, and K5 at 12 + 3 rows;
15. one mixture batch step, kernel route against plain route;
16. the mixture CLIs end to end (their main path): ``vmfnb_vae --annot
    --row`` on phase 4's matrix for 2 epochs with recording (``.clust.gz``)
    and a checkpoint, every kernel of the path launched, ``--resume`` for
    one more epoch; then ``encode --model mixture``, resident and
    streaming (bitwise equal), against the plain unfolded encoder with
    the same Gumbel noise;
17. full-width mixture training: two epochs over the first 10,000 of
    phase 5's counts, with a profile of 20 batches;
18. the generic step's kernels against their plain versions: K7
    (``nb_elbo_fwd``, both ``with_const`` instances), K8
    (``nb_elbo_bwd``) and K2v (``valgrad(need_value=True)``) at B = 100,
    D = 20,000 (int8 counts <= 7, int8 integers up to 127, non-integer
    float32) and at a ragged D = 1,003; K7 and K8 also at B = 1, 50 (a
    data-parallel rank's rows) and 300 (D = 20,000), at D = 5,001 (no
    multiple of K7's slice or of K8's 4 columns) and at B = 2,
    D = 160,000 (K7's re-read instance), with
    elements on both sides of both overdispersion clamp edges (the clamp
    mask exact); bitwise repeatability, int8 == int16 == float32 storage
    of the same integer counts for K7, K7c and K8, K2v's value against K6
    and its gradient outputs equal to K2's, bitwise; device times at the
    main path's case (int8 integers, D = 20,000);
19. one generic batch step per route, kernel route against plain route:
    ``--mean_encoding 16`` (the v2 step kernels), ``--mean_decoding 16``
    and ``--no_fused_step`` (K7 / K8), and the README's library trainer
    (``fused_step_boot``, K2v);
20. the generic step end to end (the main path of K7, K8 and K2v):
    ``nb_vae --mean_encoding 16 --mean_decoding 16`` on phase 4's matrix
    for 2 epochs with recording and a checkpoint, ``--resume`` for one
    more; ``--no_fused_step`` and ``--no_fused`` for one epoch each; the
    README's library trainer through ``train_vae_model`` for one epoch;
    ``encode --model nb`` on the hidden-layer checkpoint against the
    plain unfolded encoder (the width 16 is a test width: the reference
    publishes no hidden-layer default);
21. full-width generic training: ``nb_vae --no_fused_step``'s step at
    the default architecture, two epochs over the first 10,000 of phase
    5's counts (phase 9's model and cells: the two phases price the
    packed step against the generic one), with a profile of 20 batches;
22. K2pv (``valgrad(joint=True, need_value=True)``, the value-bearing
    joint boot step) against its plain version in phase 18's regimes and
    at D = 1,003, with exp(nu_pre) on both sides of the NU_HI clamp:
    bitwise repeatability, the gradient outputs equal to K2p's bitwise,
    the value held to the float64 sum and to K6p; device times at the
    main path's case;
23. one generic batch step per route of the vMF+NB models, kernel route
    against plain route: the joint model with ``--mean_encoding 16`` and
    ``--vmf_decoding 16`` (the v2 step kernels), ``--mean_decoding 16``
    and ``--no_fused_step`` (``forward`` + the composite loss) and the
    JAX README's library trainer (K2pv); the mixture with
    ``--mean_encoding 16``, ``--no_fused_step`` and the library trainer;
    the ``ln_kappa`` leaves held to the float64 step;
24. ``vmfnb_vae`` on the generic step end to end: ``--mean_encoding 16
    --vmf_decoding 16`` and, with ``--annot --row``, ``--mean_encoding
    16`` for 2 epochs with recording and a checkpoint, ``--resume`` for
    one more; ``--mean_decoding 16``, ``--no_fused_step`` and
    ``--no_fused`` for one epoch each; the library trainer of each model
    for one epoch (the main path of K2pv); ``encode --model vmfnb`` and
    ``--model mixture`` on hidden-layer checkpoints against the plain
    unfolded encoders;
25. full-width generic training of the joint model: the library
    trainer (K2pv's main path) at the default architecture, two epochs
    over the first 10,000 of phase 5's counts (phase 13's model and data:
    the two phases price the packed joint step against the generic one),
    with a profile of 20 batches;
26. the roofline probe P1 (``csrc/roofline_probe.cu``) against its plain
    version in all five op classes (fma, exp, log, div, select) x ILP 1
    and 4 x nrep 8 and 40 at K2's shape (100 x 20,000 float32), bitwise
    repeatable, with device times of the fma class at ILP 4, nrep 40;
    then the probe itself (``python -m
    mmvae_tpu_torch.benchmarks.valgrad_roofline``'s ``main``): per-op
    costs at ILP 1 and 4, the op-mix bracket of each K2 instance, each
    instance's two stages alone;
27. the tooling end to end: ``trace_step joint`` at D = 20,000, B = 100,
    8 batches an epoch, whose table must name the port's kernels with
    device time, and ``trace_step vmf`` at the same size (PyTorch's
    kernels only); ``nb_vae`` on phase 4's matrix with ``MMVAE_TRACE_DIR``
    set, whose trace must hold the ``ondevice_epoch`` annotation and the
    kernels and whose ``.metrics.jsonl`` rows the JAX trainer's
    ``time_*`` keys;
28. K2's cases: the four ``nb_valgrad`` instances against their plain
    version at B in {1, 37, 50, 100, 1600} x D in {255, 256, 257, 1003,
    20,000}, with the compile-time widths (2, 1, 1) and the general
    instance at (4, 2, 3), and at B in {37, 100} x D in {257, 20,000}
    with the widths the reference trains past 16 stacked rows (T = 17,
    17, 17 with pb, 24, 45, 128), counts stored as int8, int16 and
    float32 (bitwise equal) and non-integer float32 (and counts <= 7 at
    the wide widths): each bitwise repeatable, the value-bearing
    gradients equal to the grad-only ones bitwise;
29. K5's and K1's cases: every ``count_encode_bwd`` instance against its
    plain version at M in {1, 37, 50, 100, 1600} x D in {255, 256, 257,
    1003, 20,000} x (r1, r2) in {(2, 2), (5, 3), (12, 3), (2, 0),
    (16, 0), (7, 9)}, counts stored as int8, int16 and float32 (bitwise equal)
    and non-integer float32; both ``nb_lse`` instances at the same B x D
    x (R, C) in {(2, 1), (4, 2), (15, 0)} and at the wide widths' (R, C)
    and (13, 3) on phase 28's subset; each call bitwise repeatable,
    each case on the instance its plan names; then K5 at the trainers'
    widths and K1 at (2, 1) on the main path's shape, stage 1 and stage
    2 apart, beside the plain versions and K5's library products;
30. K6's, K6p's and K3's cases: ``value`` (with and without
    lgamma(x + 1)), ``value(joint=True)`` and ``finish`` against their
    plain versions on phase 28's grid and wide widths and counts: each
    call bitwise repeatable, K6's int8 == int16 == float32; then the
    three at the main path's shape, stage 1 and stage 2 apart; and K1,
    K6, K6p, K2, K2p and K3 at the TP launch shape of phases 39-41 (B =
    100, D = 10,000, int8) beside their plain versions;
31. a wide model's trainer: ``nb_vae --mean_latent 13`` (17 stacked
    rows) on phase 4's matrix for one epoch, every kernel of the NB path
    launched (its step kernels on their general instances), the score
    finite;
32. one vMF-VAE batch step at B = 100, D = 20,000 int8: the packed step
    against the generic ``Trainer`` with the same draws, at the JAX
    suite's tolerance; int8 == int16 == float32 storage and two runs,
    bitwise.  The vMF-VAE is plain PyTorch (the JAX package computes it
    in XLA): its path launches no kernel of the port, which this and the
    next two phases check;
33. the vMF-VAE's CLIs end to end on phase 4's matrix: ``vmf_vae`` for 2
    epochs with recording and a checkpoint, ``--resume`` for one more;
    ``vmf_vae --encoding 16 --decoding 16`` (the generic step) for one
    epoch; ``encode --model vmf`` on the checkpoint, resident and
    streaming (bitwise equal), against the plain unfolded encoder;
34. full-width vMF-VAE training: two epochs over the first 20,000 of
    phase 5's counts, with a profile of 20 batches and kappa before and
    after;
35. the data tiers beyond the dense budget end to end: ``nb_vae`` on
    phase 4's matrix for 2 epochs with recording and a checkpoint on the
    ELL-resident tier, on rotating host shards in the dense, ell and csr
    layouts (4 or more shards) and with half the shards resident, with
    ``--data_mode stream`` and with ``--no_auto_ondevice`` (budgets set
    through ``MMVAE_DENSE_BYTES``, ``MMVAE_ROTATE``, ``MMVAE_SHARD_BYTES``,
    ``MMVAE_SHARD_LAYOUT`` and ``MMVAE_PIN_BYTES``, scaled to the depth):
    each run's scores.gz, artifacts and checkpoint equal phase 42's
    unclustered dense-resident run (the tiers never cluster) bitwise,
    every NB kernel launched; ``--resume`` from a rotating run's epoch-1
    checkpoint equal to the uninterrupted run; ``vmfnb_vae``,
    ``vmfnb_vae --annot --row`` and ``vmf_vae`` on rotation (csr) equal
    to phase 42's unclustered runs and phase 33's run bitwise;
36. the rotating tier at depth: phase 9's 40,000 cells copied to a host
    CSC, 8 shards in the layout the store picks, 4 of them resident, the
    NB packed step for 2 epochs from phase 9's seed and initialization:
    reports and parameters equal phase 9's bitwise, with cells/sec beside
    phase 9's, the device idle share, the bytes copied host to device an
    epoch, the copy stream's busy time and the compute stream's waits on
    copies; then the ELL-resident tier on the same cells;
37. data-parallel training end to end on two ranks, each a process of
    this script (``--dp-worker``; NCCL on two cards when the machine has
    two, gloo with both ranks on the one card otherwise, the phase says
    which): ``nb_vae --data_parallel`` (the host path) and ``--dp_shard``
    (dense-resident, DP layout) on phase 4's matrix, 2 epochs with
    recording and a checkpoint, each run twice and resumed from its
    epoch-1 checkpoint (bitwise equal), ``--data_parallel`` within
    :data:`DP_TOL` of phase 42's unclustered single-process run (a
    data-parallel run never clusters); then one epoch each
    of ``vmfnb_vae``, ``vmfnb_vae --annot --row``, ``vmf_vae`` and ``nb_vae
    --mean_decoding 16`` under ``--dp_shard``; on each rank every kernel
    of each path launched, every launch at 50 rows and at a shape (rows,
    D, storage, widths and instance: :data:`SHAPE_ARGS`) at which phases
    2, 6, 10, 14, 18, 22 and 28-30 held that kernel against its plain
    version in this run (:func:`launch_shapes`), the ranks' final
    parameters bitwise equal, rank 0 alone writing;
38. data parallel at full width: the NB packed step under ``--dp_shard``
    on the two ranks over phase 9's 40,000 cells (each rank makes phase
    5's counts on its card from the seed and keeps its 50 rows of every
    batch), phase 9's seed and initialization, 2 epochs: cells/sec summed
    over the ranks beside phase 9's, each rank's device idle share, and
    the gradient all-reduce's time a batch;
39. tensor-parallel training end to end on two ranks of one model row
    (``--tp-worker``; the backend as in 37): ``nb_vae``, ``vmfnb_vae``,
    ``vmfnb_vae --annot --row`` and ``vmf_vae`` with ``--tensor_parallel
    2`` on phase 4's matrix at full width (each rank 10,000 of its 20,000
    genes), one epoch each with a checkpoint (``nb_vae`` two, and once
    one epoch resumed to two: bitwise equal), each held to one process of
    the port's generic ``Trainer`` on the full parameters fed the same
    draws (data index 0) within :data:`TP_TOL`; on each rank K1, K6 / K6p,
    K2 / K2p and K3 launched and K4 and K5 not (the TP encoders are plain,
    as in JAX), every launch at D / 2 columns and at a shape phases 28-30
    held against plain in this run, the ranks' final parameters bitwise
    equal, rank 0 alone writing;
40. tensor-parallel serving: ``encode --tensor_parallel 2`` of phase 39's
    four checkpoints, no kernel launched, against ``encode`` in one
    process within phase 12's tolerance (the mixture's assignments equal
    but for near-ties);
41. tensor parallel at full width: phase 9's NB model and the first
    10,000 of its cells under ``--tensor_parallel 2``'s step, 2 epochs: epoch-2 cells/sec
    beside phase 9's, each rank's device idle share, the collectives' ms
    a batch (K1, K6, K6p, K2, K2p and K3 at the TP launch shape, B =
    100, D = 10,000, int8, are timed against their plain versions at the
    close of phase 30);
42. feature clustering (``train.loop.cluster_features``), after phase 33:
    ``benchmarks.perm_probe`` on phase 4's matrix (its hot genes; the
    share of 64-column regime tiles a batch in each lgamma regime in
    input and cold-first order; K2, K6 and K3 on its first batches in
    both orders, each held against its plain version at phase 6's
    tolerance, device ms by CUDA graph replays); ``nb_vae``, ``vmfnb_vae``
    and ``vmfnb_vae --annot --row`` with ``MMVAE_FEATURE_PERM=0``, phase
    8, 12 and 16's flags (the references of phases 35 and 37), against
    which phase 8, 12 and 16's clustered runs hold within
    :data:`CLUSTER_TOL` every output that the packed step and
    ``--no_fused_step`` (both unclustered) agree on within it, the rest
    reported beside that route gap; each
    clustered model run for one epoch with a checkpoint and resumed to
    two, equal to phase 8, 12 or 16's run bitwise, every kernel of its
    path launched; then ``train_vae_model``
    with the recorder's background writer and without (4 epochs,
    recording every 2, in turns off / on / on / off): the same
    decompressed files, the epochs' cells/sec and ``time_record_submit``;
43. the superbatch step (``train.superbatch``, JAX's ``--superbatch``),
    after phase 36: the NB packed step, ``nb_vae --no_fused_step``'s
    generic step and the joint, mixture and vMF-VAE packed steps at
    full width (the first 37 batches of phase 5's counts: superbatches
    of 8 and 5), 3 epochs with the second recording, through the S = 8
    CUDA graphs and through the eager per-batch path on the same
    draws: parameters, Adam state, reports and posteriors bitwise
    equal, the launches replayed equal to the eager run's (every
    kernel of the route counted), a profiled replay of the 8-batch
    graph launching each port kernel as often as the graph books, a
    resume from a checkpoint of epoch 0 through the same graphs bitwise; each route's cells/sec both
    ways, wall and device-busy ms a batch, device ops a batch, the idle
    share, the capture seconds and the graphs' pool.

Every single-process trainer CLI run (phases 8, 12, 16, 20, 24, 27,
31, 33, 35, 42) trains through the superbatch graphs (``--superbatch``
8, JAX's default); the library runs of phases 9, 13, 17, 21, 25, 34 and
36 are the eager per-batch path (``superbatch=None``), as phase 43's
reference; the meshes of 37-41 step one batch at a time.

Each main path (phases 4, 8, 12, 16, the runs of 20 and 24, the
probe's run in 26, the wide trainer of 31, the vMF-VAE's runs of 32,
33, 34 and 5, each tier's run in 35 and 36, each run of 37-41 on
each rank, each trainer run of 42 and each route's graph run in 43)
is driven with every launch counter set to 0 just before it and read
just after.
The last two lines are the kernels' JSON record (with each kernel's
bound at the main path's shape) and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import gzip
import hashlib
import io
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SEED = 0
D_GENES = 20000
N_CLI = 4000        # cells of the synthetic CLI matrix
N_FULL = 100_000    # cells of the full-size phases
# cells the full-size training phases walk: their depth is cut to keep
# the script well inside its time limit on a slow host; the NB packed
# step (9) takes the longer walk, which phases 36 and 38 repeat on the
# rotating tier and two DP ranks
N_EARLIER = 40_000
# the joint and mixture models and the generic steps (13, 17, 21, 25)
# and the TP step (41, cut from 40,000 to make room for phase 42); their
# cells/sec are per cell, so phases 21 and 41 still price their steps
# against phase 9's packed one
N_SHORT = 10_000
# the vMF-VAE (34): its loss at D = 20,000 falls by about one float32
# ulp of its value over two epochs of this walk
N_VMF = 20_000
B_TRAIN = 100
DP_WORLD = 2  # the ranks of phases 37-38
DP_M = B_TRAIN // DP_WORLD  # the rows of every batch a rank owns
DEV = "cuda"
TOL = "|kernel - plain| <= 1e-5 * S + 1e-6, S = |log1p x| @ |WL|^T (|x| @ |WX|^T)"


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, warmup: int = 3, reps: int = 200) -> float:
    """Milliseconds per call: CUDA events around ``reps`` back-to-back
    calls after warm-ups (what a loop of such calls pays; equals the
    device time when the device, not the host, is the bottleneck)."""
    for _ in range(warmup):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def device_profile(fn, reps: int = 1):
    """(device ms per call, {kernel name: device ms per call}) of the
    kernels ``fn`` runs on the card, from torch.profiler (CUPTI) through
    the port's one reader of kernel time
    (``mmvae_tpu_torch.utils.profiling.kernel_times``: the CUDA device
    events summed by name).  ``device_profile.kernels`` holds the number
    of kernels per call."""
    from torch.profiler import ProfilerActivity, profile

    from mmvae_tpu_torch.utils.profiling import kernel_times

    # every call launches the same kernels, so a trace whose device event
    # count is not a positive multiple of reps lost events: it is retried
    for _attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kt = kernel_times(prof)
        per = {k: us for k, (us, _) in kt.items()}
        n = sum(c for _, c in kt.values())
        if n and n % reps == 0:
            break
    else:
        # no whole trace in three: time with CUDA events instead
        device_profile.kernels = 0
        ms = cuda_ms(fn, warmup=1, reps=reps)
        return ms, {"(CUDA events; the profiler lost kernels)": ms}
    device_profile.kernels = n / reps
    per = {k: v / reps / 1e3 for k, v in per.items()}
    return sum(per.values()), per


# the arguments of each C entry of the kernel library that fix a launch's
# shape: (integer arguments, pointer arguments counted as present or not)
SHAPE_ARGS = {
    # M, D, storage, log1p rows, raw rows; row stats, filter
    "mmvae_count_encode_fwd": ((2, 3, 1, 5, 7), (12, 13)),
    # M, D, storage, the launch's log1p rows and raw rows
    "mmvae_count_encode_bwd": ((2, 3, 1, 5, 8), ()),
    "mmvae_nb_lse": ((2, 3, 4, 5), ()),  # B, D, R, C
    # B, D, storage, R, C, Rn, joint
    "mmvae_nb_value": ((7, 8, 1, 9, 10, 11, 13), ()),
    # B, D, storage, R, C, Rn, joint, need_value
    "mmvae_nb_valgrad": ((7, 8, 1, 9, 10, 11, 12, 13), ()),
    "mmvae_nb_finish": ((4, 5, 6, 7), ()),  # B, D, R, C
    "mmvae_nb_elbo_fwd": ((5, 6, 1, 7), ()),  # B, D, storage, with_const
    "mmvae_nb_elbo_bwd": ((8, 9, 2), ()),  # B, D, storage
}
# {C entry: set of shapes} of the launches that phases 2, 6, 10, 14, 18,
# 22 and 28-30 held against their plain versions in this run
HELD: dict = {}


@contextlib.contextmanager
def launch_shapes(into: dict):
    """Within the block, add each launch's shape (:data:`SHAPE_ARGS`) to
    ``into`` ({C entry: set of tuples}); the entries are restored
    after."""
    from mmvae_tpu_torch.ops import _cuda

    lib = _cuda.lib()
    real = {name: getattr(lib, name) for name in SHAPE_ARGS}

    def wrap(name, fn):
        ints, ptrs = SHAPE_ARGS[name]

        def call(*a):
            into.setdefault(name, set()).add(
                tuple(int(a[i]) for i in ints)
                + tuple(int(bool(a[i])) for i in ptrs))
            return fn(*a)
        return call

    for name, fn in real.items():
        setattr(lib, name, wrap(name, fn))
    try:
        yield into
    finally:
        for name, fn in real.items():
            setattr(lib, name, fn)


def ptxas_summary(build_log: str) -> str:
    """Per source of the build log (``== <file>`` sections): kernel
    instances, their register range and the bytes they spill."""
    out = []
    for name, body in re.findall(r"^== (\S+)\n(.*?)(?=^== |\Z)", build_log,
                                 re.M | re.S):
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", body)]
        if regs:
            spill = sum(int(a) + int(b) for a, b in re.findall(
                r"(\d+) bytes spill stores, (\d+) bytes spill loads", body))
            out.append(f"{name} {len(regs)} kernels, {min(regs)}-"
                       f"{max(regs)} registers, {spill} bytes spilled")
    return "; ".join(out)


def encode_label(name: str) -> str:
    """A ``count_encode.cu`` instance by its stage-1 template arguments,
    read from the mangled name: count dtype, log1p and raw row bounds
    NL + NX, STATS, FILT."""
    m = re.search(r"count_encode_tilesI(\w)Li(\d+)ELi(\d+)ELb(\d)ELb(\d)E",
                  name)
    if m is None:
        return "sum"
    return (f"{DTYPE_CODES[m[1]]} {m[2]}+{m[3]}"
            + ("+filt" if m[5] == "1" else "+stats" if m[4] == "1" else ""))


def valgrad_label(name: str) -> str:
    """A ``nb_valgrad.cu`` instance by its stage-1 template arguments:
    count dtype, the compile-time widths R+C+Rn (0+0+0: the general
    instance), JOINT, VALUE."""
    m = re.search(r"valgrad_tilesI(\w)Li(\d+)ELi(\d+)ELi(\d+)ELb(\d)ELb"
                  r"(\d)E", name)
    if m is None:
        return "sum"
    return (f"{DTYPE_CODES[m[1]]} "
            + (f"{m[2]}+{m[3]}+{m[4]}" if m[2] != "0" else "general")
            + ("+joint" if m[5] == "1" else "")
            + ("+value" if m[6] == "1" else ""))


def bwd_label(name: str) -> str:
    """A ``count_encode_bwd.cu`` instance by its stage-1 template
    arguments: count dtype and the compile-time widths NL+NX (0+0: the
    general instance)."""
    m = re.search(r"count_encode_bwd_tilesI(\w)Li(\d+)ELi(\d+)E", name)
    if m is None:
        return "sum"
    return (f"{DTYPE_CODES[m[1]]} "
            + (f"{m[2]}+{m[3]}" if m[2] + m[3] != "00" else "general"))


def value_label(name: str) -> str:
    """A ``nb_value.cu`` instance by its stage-1 template arguments: count
    dtype, the compile-time widths R+C+Rn (0+0+0: the general instance),
    CONST, JOINT."""
    m = re.search(r"value_tilesI(\w)Li(\d+)ELi(\d+)ELi(\d+)ELb(\d)ELb"
                  r"(\d)E", name)
    if m is None:
        return "sum"
    return (f"{DTYPE_CODES[m[1]]} "
            + (f"{m[2]}+{m[3]}+{m[4]}" if m[2] != "0" else "general")
            + ("+const" if m[5] == "1" else "")
            + ("+joint" if m[6] == "1" else ""))


def finish_label(name: str) -> str:
    """A ``nb_finish.cu`` instance by its stage-1 template arguments: the
    compile-time widths R+C (0+0: the general instance)."""
    m = re.search(r"finish_tilesILi(\d+)ELi(\d+)E", name)
    if m is None:
        return "sum"
    return f"{m[1]}+{m[2]}" if m[1] != "0" else "general"


def elbo_label(name: str) -> str:
    """A ``nb_elbo.cu`` instance by its template arguments: K7's stage 1
    (count dtype, CONST, on-chip or re-read) or K8 (count dtype, vector
    loads)."""
    m = re.search(r"elbo_fwd_rowsI(\w)Lb(\d)ELb(\d)E", name)
    if m is not None:
        return (f"K7 {DTYPE_CODES[m[1]]}" + ("+const" if m[2] == "1" else "")
                + (" onchip" if m[3] == "1" else " reread"))
    m = re.search(r"elbo_bwd_groupsI(\w)Lb(\d)E", name)
    if m is not None:
        return f"K8 {DTYPE_CODES[m[1]]}" + (" vec" if m[2] == "1" else "")
    return "sum"


def lse_label(name: str) -> str:
    """A ``nb_lse.cu`` instance by its stage-1 template argument: the
    compile-time R + C (0: the general instance)."""
    m = re.search(r"lse_tilesILi(\d+)E", name)
    if m is None:
        return "sum"
    return f"R+C={m[1]}" if m[1] != "0" else "general"


DTYPE_CODES = {"a": "int8", "s": "int16", "f": "f32"}


def kernel_instances(build_log: str, source: str,
                     label) -> list[tuple[str, int, int]]:
    """(label, registers, bytes of spill stores) of every kernel instance
    compiled from ``source`` (its ``== <source>`` section of the build
    log), each named by ``label`` from its mangled name."""
    body = re.search(rf"^== {re.escape(source)}\n(.*?)(?=^== |\Z)", build_log,
                     re.M | re.S)
    return [(label(name), int(regs), int(spill))
            for name, spill, regs in re.findall(
                r"Compiling entry function '(\w+)'.*?(\d+) bytes spill "
                r"stores.*?Used (\d+) registers",
                body.group(1) if body else "", re.S)]


def check_instances(build_log: str, source: str,
                    label) -> list[tuple[str, int, int]]:
    """``kernel_instances``, raising when the log holds none or any of
    them spills: the designs hold every instance in registers (launch
    bounds chosen per instance)."""
    instances = kernel_instances(build_log, source, label)
    if not instances:
        raise AssertionError(f"{source}: no instance in the build log")
    spilled = [n for n, _, b in instances if b]
    if spilled:
        raise AssertionError(f"{source} instances spill: {spilled}")
    return instances


def make_counts(g: torch.Generator, M: int, D: int, dtype) -> torch.Tensor:
    """Seeded counts on the card: Poisson around a log-normal gene
    profile (~1.5 mean), clipped to the dtype; float32 gets non-integer
    values."""
    if dtype == torch.float32:
        u = torch.rand((M, D), generator=g, device=DEV)
        return -torch.log1p(-u) * 3.0
    prof = torch.exp(torch.randn((1, D), generator=g, device=DEV))
    rate = (prof / prof.mean() * 1.5).expand(M, D).contiguous()
    x = torch.poisson(rate, generator=g)
    hi = 127 if dtype == torch.int8 else 32767
    return x.clamp_(max=hi).to(dtype)


def scaled_err(got, want, S):
    """(max |got - want|, max ratio to the tolerance)."""
    err = (got.double() - want.double()).abs()
    return err.max().item(), (err / (1e-5 * S + 1e-6)).max().item()


def phase_kernels(enc, card):
    cases = [(100, 20000, 2, 2, torch.int8), (100, 20000, 2, 2, torch.int16),
             (100, 20000, 2, 2, torch.float32), (37, 1003, 5, 0, torch.int8),
             (37, 255, 3, 1, torch.float32), (37, 256, 2, 2, torch.int8),
             (37, 257, 2, 0, torch.int16),  # D at the tile edges
             (1600, 20000, 2, 0, torch.int8),
             (100, 20000, 24, 2, torch.int16),
             # a data-parallel rank's rows (phase 37): packed, generic
             (DP_M, 20000, 2, 2, torch.int8), (DP_M, 20000, 2, 0, torch.int8)]
    g = torch.Generator(device=DEV).manual_seed(SEED)
    worst = 0.0
    times = {}
    log(f"[phase 2] count_encode kernel vs plain (f32, TF32 off); {TOL}")
    for M, D, r1, r2, dt in cases:
        x = make_counts(g, M, D, dt)
        WL = torch.randn((r1, D), generator=g, device=DEV) * 0.1
        WX = (torch.randn((r2, D), generator=g, device=DEV) * 0.01
              if r2 else None)
        with launch_shapes(HELD):  # only here: the timing below is bare
            hL, hX = enc.count_encode(x, WL, WX)
        eL, eX = enc.count_encode_ref(x, WL, WX)
        torch.cuda.synchronize()
        xf = x.double()
        e1, q1 = scaled_err(hL, eL, xf.log1p().abs() @ WL.double().abs().T)
        e2, q2 = (scaled_err(hX, eX, xf.abs() @ WX.double().abs().T)
                  if r2 else (0.0, 0.0))
        if not (q1 <= 1.0 and q2 <= 1.0):
            raise AssertionError(f"kernel disagrees at {(M, D, r1, r2, dt)}: "
                                 f"err/tol {q1:.3g}, {q2:.3g}")
        worst = max(worst, e1, e2)
        k_ms = cuda_ms(lambda: enc.count_encode(x, WL, WX))
        p_ms = cuda_ms(lambda: enc.count_encode_ref(x, WL, WX))
        k_dev, _ = device_profile(lambda: enc.count_encode(x, WL, WX), 20)
        p_dev, _ = device_profile(lambda: enc.count_encode_ref(x, WL, WX),
                                  20)
        times[(M, D, r1, r2, dt)] = (k_dev, p_dev)
        log(f"[phase 2] [{card}] M={M} D={D} r1={r1} r2={r2} "
            f"{str(dt).replace('torch.', '')}: max_abs_err hL {e1:.3g} "
            f"hX {e2:.3g} (err/tol {max(q1, q2):.3g}); per call "
            f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms; device time "
            f"kernel {k_dev:.4f} ms, plain {p_dev:.4f} ms")
    # the serving sweep's launch and the NB trainer's (its 360 launches)
    return worst, (times[(1600, 20000, 2, 0, torch.int8)],
                   times[(100, 20000, 2, 2, torch.int8)])


def phase_chunks(enc):
    """Phase 3: each forward instance's result depends only on D and the
    row's data: launch grouping, storage dtype and the run change no
    bit."""
    g = torch.Generator(device=DEV).manual_seed(SEED + 1)
    x = make_counts(g, 1600, D_GENES, torch.int8)
    filt = torch.from_numpy(marker_label().any(axis=1).astype(
        np.float32)).to(DEV)
    ragged = [0, 1, 38, 100] + list(range(200, 1601, 100))
    for name, r1, r2, kw in (
            ("count_encode", 2, 0, {}),
            ("count_encode[stats]", 5, 3, dict(want_stats=True)),
            ("count_encode[filt]", 12, 3, dict(want_stats=True,
                                               filt=filt))):
        WL = torch.randn((r1, D_GENES), generator=g, device=DEV) * 0.1
        WX = (torch.randn((r2, D_GENES), generator=g, device=DEV) * 0.01
              if r2 else None)

        def run(xx, cuts=(0, 1600)):
            parts = [enc.count_encode(xx[a:b], WL, WX, **kw)
                     for a, b in zip(cuts, cuts[1:])]
            return [torch.cat(t) for t in zip(*parts)]

        one = run(x)
        for what, got in (
                ("16 launches x 100 rows", run(x, range(0, 1601, 100))),
                ("a ragged split 1 + 37 + 62 + 15 x 100", run(x, ragged)),
                ("int16 storage", run(x.to(torch.int16))),
                ("float32 storage", run(x.float())),
                ("a second run", run(x))):
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(one, got)):
                raise AssertionError(f"{name}: 1 launch x 1600 rows (int8) "
                                     f"!= {what}")
        log(f"[phase 3] {name} ({r1} + {r2} rows): 1 launch x 1600 rows == "
            f"16 x 100 == 1 + 37 + 62 + 15 x 100; int8 == int16 == float32 "
            f"storage; two runs equal; bitwise")


def plain_encode(params, x):
    """Independent plain reference of NBVAE.encode_mu (default
    architecture): the unfolded standardization, as the JAX model
    writes it."""
    sd = torch.nn.functional.softplus(params["ln_x_sd"]) + 1e-4
    xn = (torch.log1p(x.float()) - params["x_mean"]) / sd
    h = xn @ params["mu_encoding"]["weight"] + params["mu_encoding"]["bias"]
    lin = lambda n: h @ params[n]["weight"] + params[n]["bias"]  # noqa: E731
    S = ((torch.log1p(x.double()) + params["x_mean"].double().abs())
         @ (params["mu_encoding"]["weight"].double().abs() / sd.double().T)
         + params["mu_encoding"]["bias"].double().abs())
    bound = {n: S @ params[n]["weight"].double().abs()
             + params[n]["bias"].double().abs()
             for n in ("mu_representation_mean",
                       "mu_representation_logvariance")}
    return (lin("mu_representation_mean"),
            lin("mu_representation_logvariance").clamp(-4.0, 4.0), bound)


def random_params(model, device):
    """Seeded params with non-trivial learned standardization (on the
    scale of the model's encoder input: log1p counts for NB, their unit
    row for the vMF+NB models) and, for the mixture, component
    directions that are not uniform."""
    params = model.init(torch.Generator().manual_seed(SEED), device=device)
    g = torch.Generator().manual_seed(SEED + 1)
    D = model.data_dim
    scale = 1.5 if type(model).__name__ == "NBVAE" else 1.5 / D ** 0.5
    params["x_mean"] = torch.rand((1, D), generator=g).to(device) * scale
    params["ln_x_sd"] = (torch.randn((1, D), generator=g) * 0.5).to(device)
    if "ln_vmf_mu" in params:
        params["ln_vmf_mu"] = torch.randn(tuple(params["ln_vmf_mu"].shape),
                                          generator=g).to(device)
    return params


K_MIX = 10  # mixture components of the full-size configuration


def marker_label(genes: int = 200) -> np.ndarray:
    """(D, K) marker-gene annotation from seed 0: each of the K_MIX
    components holds ``genes`` genes drawn at random (overlaps allowed),
    so about D (1 - (1 - genes / D)^K) genes are covered (~1,900 of
    20,000)."""
    rng = np.random.default_rng(SEED)
    L = np.zeros((D_GENES, K_MIX), np.float32)
    for k in range(K_MIX):
        L[rng.choice(D_GENES, genes, replace=False), k] = 1.0
    return L


def write_annotation(tmp: str, label: np.ndarray) -> tuple[str, str]:
    """``--annot`` / ``--row`` files whose ``Annotation.matrix()`` is
    ``label`` (pairs grouped by component, so labels keep its order)."""
    row = os.path.join(tmp, "genes.txt")
    annot = os.path.join(tmp, "markers.txt")
    with open(row, "w") as f:
        f.writelines(f"gene{i}\n" for i in range(label.shape[0]))
    with open(annot, "w") as f:
        for k in range(label.shape[1]):
            f.writelines(f"gene{i} marker{k}\n"
                         for i in np.nonzero(label[:, k])[0])
    return annot, row


class _Tee(io.TextIOBase):
    def __init__(self, sink):
        self.sink, self.buf = sink, io.StringIO()

    def write(self, s):
        self.sink.write(s)
        return self.buf.write(s)

    def flush(self):
        self.sink.flush()


def run_cli(encode, args):
    tee = _Tee(sys.stderr)
    with contextlib.redirect_stderr(tee):
        rc = encode.main(args)
    if rc != 0:
        raise AssertionError(f"encode CLI exited {rc}")
    return tee.buf.getvalue()


def read_mtx_dense(path: str) -> np.ndarray:
    """(cells, genes) float32 counts from a coordinate MatrixMarket file,
    parsed with plain numpy: a reference independent of the port's
    reader."""
    with gzip.open(path, "rt") as f:
        line = f.readline()
        while line.startswith("%"):
            line = f.readline()
        D, N, nnz = map(int, line.split())
        trip = np.loadtxt(f, dtype=np.float64, ndmin=2)
    if len(trip) != nnz:
        raise AssertionError(f"{path}: {len(trip)} triplets, header {nnz}")
    x = np.zeros((N, D), np.float32)
    x[trip[:, 1].astype(np.int64) - 1, trip[:, 0].astype(np.int64) - 1] = (
        trip[:, 2])
    return x


def phase_cli(card, tmp):
    from mmvae_tpu_torch.cli import encode, make_synthetic
    from mmvae_tpu_torch.models.nb import NBVAE
    from mmvae_tpu_torch.ops import enc_kernel
    from mmvae_tpu_torch.train.checkpoint import save_checkpoint

    N = N_CLI
    mtx = os.path.join(tmp, "syn.mtx.gz")
    t0 = time.time()
    make_synthetic.main(["--out", mtx, "--genes", str(D_GENES),
                         "--cells", str(N), "--depth_mean", "1000",
                         "--seed", str(SEED), "--index"])
    log(f"[phase 4] synthetic {N} x {D_GENES} matrix in "
        f"{time.time() - t0:.1f}s (host)")
    model = NBVAE(data_dim=D_GENES)
    params = random_params(model, DEV)
    ckpt = os.path.join(tmp, "ckpt")
    save_checkpoint(ckpt, params, epoch=0, seed=SEED)
    args = ["--model", "nb", "--mtx", mtx, "--checkpoint", ckpt,
            "--batch_size", "100", "--device", DEV]

    enc_kernel.count_encode.launches = 0
    t0 = time.time()
    err = run_cli(encode, args + ["--out", os.path.join(tmp, "res")])
    wall = time.time() - t0
    launches = enc_kernel.count_encode.launches
    if "dense-resident" not in err:
        raise AssertionError("resident sweep did not run")
    if launches < 1:
        raise AssertionError("main path launched no count_encode kernel")
    fill = [ln for ln in err.splitlines() if "dense fill:" in ln][-1]
    rate = [ln for ln in err.splitlines() if "cells/sec" in ln][-1]
    log(f"[phase 4] host reader: {fill.split('] ', 1)[-1]}")
    log(f"[phase 4] [{card}] resident CLI: {launches} count_encode "
        f"launches; {rate.split('] ', 1)[-1]}; CLI wall {wall:.2f}s")

    res = [np.loadtxt(os.path.join(tmp, f"res.mu_{k}.gz"), ndmin=2)
           for k in ("mean", "lnvar")]
    for a in res:
        if a.shape != (N, 2) or not np.isfinite(a).all():
            raise AssertionError(f"bad output {a.shape}")
    # plain-version reference on the card from the same counts
    with torch.inference_mode():
        x = torch.from_numpy(read_mtx_dense(mtx)).to(DEV)
        rm, rl, bound = plain_encode(params, x)
    worst = 0.0
    for got, want, n in ((res[0], rm, "mu_representation_mean"),
                         (res[1], rl, "mu_representation_logvariance")):
        want = want.double().cpu().numpy()
        lim = (1e-5 * bound[n].cpu().numpy() + 1e-6
               + 1e-5 * np.abs(want))  # + %g text rounding (6 digits)
        ratio = np.max(np.abs(got - want) / lim)
        worst = max(worst, ratio)
        if not ratio <= 1.0:
            raise AssertionError(f"{n}: CLI output vs plain err/tol "
                                 f"{ratio:.3g}")
    log(f"[phase 4] outputs ({N}, 2), finite, match the plain encode "
        f"(err/tol {worst:.3g}; tol 1e-5*S + 1e-6 + 1e-5*|ref|)")

    os.environ["MMVAE_DENSE_BYTES"] = "1"
    try:
        t0 = time.time()
        err = run_cli(encode, args + ["--out", os.path.join(tmp, "str")])
    finally:
        del os.environ["MMVAE_DENSE_BYTES"]
    if "resident fast path skipped" not in err:
        raise AssertionError("streaming sweep did not run")
    for k, a in zip(("mean", "lnvar"), res):
        b = np.loadtxt(os.path.join(tmp, f"str.mu_{k}.gz"), ndmin=2)
        if not np.array_equal(a, b):
            raise AssertionError(f"streaming mu_{k} != resident")
    log(f"[phase 4] [{card}] streaming CLI equals resident bitwise "
        f"(CLI wall {time.time() - t0:.2f}s)")
    return launches, mtx


def full_size_counts() -> torch.Tensor:
    """N_FULL x D_GENES int8 counts made on the card (~1000 per cell)."""
    g = torch.Generator(device=DEV).manual_seed(SEED + 2)
    prof = torch.exp(torch.randn((1, D_GENES), generator=g, device=DEV))
    rate = prof / prof.sum() * 1000.0  # ~1000 counts per cell
    data = torch.empty((N_FULL, D_GENES), dtype=torch.int8, device=DEV)
    step = min(10_000, N_FULL)
    for lo in range(0, N_FULL, step):
        r = rate.expand(step, D_GENES).contiguous()
        data[lo:lo + step] = torch.poisson(r, generator=g).clamp_(
            max=127).to(torch.int8)
    return data


def phase_full(card, data):
    from mmvae_tpu_torch.models.nb import NBVAE
    from mmvae_tpu_torch.train.loop import encode_resident

    N, B, chunk = N_FULL, 100, 16
    model = NBVAE(data_dim=D_GENES)
    params = random_params(model, DEV)
    with torch.inference_mode():
        encode_resident(model, params, data, B, chunk)  # warm-up
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mean, lnvar = encode_resident(model, params, data, B, chunk)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        busy, per = device_profile(
            lambda: encode_resident(model, params, data, B, chunk))
        rm, rl, bound = plain_encode(params, data[:1000])
    for got, want, n in ((mean[:1000], rm, "mu_representation_mean"),
                         (lnvar[:1000], rl,
                          "mu_representation_logvariance")):
        _, q = scaled_err(got, want, bound[n])
        if not q <= 1.0:
            raise AssertionError(f"full sweep {n}: err/tol {q:.3g}")
    if not (mean.shape == (N, 2) and torch.isfinite(mean).all()
            and torch.isfinite(lnvar).all()):
        raise AssertionError("full sweep output not finite (N, 2)")
    dt = statistics.median(times)
    log(f"[phase 5] [{card}] resident sweep {N} x {D_GENES} int8, B={B}, "
        f"chunk {chunk}: {N / dt:,.1f} cells/sec (median of 3: "
        f"{', '.join(f'{t * 1e3:.3f}' for t in times)} ms); first 1000 "
        f"rows match the plain encode")
    top = sorted(per.items(), key=lambda kv: -kv[1])[:5]
    log(f"[phase 5] [{card}] one sweep: device busy {busy:.3f} ms of "
        f"{dt * 1e3:.3f} ms wall (idle share {1 - busy / (dt * 1e3):.1%}); "
        + "; ".join(f"{k[:60]} {v:.3f} ms" for k, v in top))


# ----------------------------------------------------------------------
# training phases (6-9)
# ----------------------------------------------------------------------

TRAIN_TOL = ("|kernel - plain| <= 2e-5 * S + 1e-7 * max S, S = the same sum "
             "over the magnitudes of its terms (float64)")
REGIMES = [(B_TRAIN, D_GENES, torch.int8, "counts<=7"),
           (B_TRAIN, D_GENES, torch.int8, "integer"),
           (B_TRAIN, D_GENES, torch.int16, "integer"),
           (B_TRAIN, D_GENES, torch.float32, "non-integer"),
           (B_TRAIN, 1003, torch.int8, "integer")]
MAIN_CASE = 1  # int8 integer counts at B = 100, D = 20000: the main path


def step_inputs(g, B, D, dtype, regime, widths=(2, 1, 1)):
    """Counts in the named lgamma regime and the step kernels' other
    operands, at the scales the trainer gives them (library-size depth,
    unit latents, decoder rows of a few tenths); ``widths`` (R, C, Rn)."""
    x = make_counts(g, B, D, dtype)
    if regime == "counts<=7":
        x = x.clamp(max=7)
    R, C, Rn = widths
    zc = torch.randn((B, R + C), generator=g, device=DEV)
    zc[:, R:] = 1.0  # the all-ones covariate
    zn = torch.randn((B, Rn), generator=g, device=DEV)
    depth = (x.float().sum(1, keepdim=True)
             * (0.5 + torch.rand((B, 1), generator=g, device=DEV)))
    W = torch.randn((R + C + Rn + 2, D), generator=g, device=DEV) * 0.3
    return x, zc, zn, depth.contiguous(), W.contiguous(), (R, C, Rn)


def grad_magnitudes(x, zc, zn, depth, l, W, R, C, Rn, joint=False):
    """float64 per-element magnitudes of what K2 sums: |dls| and |dnupre|
    bounded by the magnitudes of their own terms (the cancellations in
    t - x/mu and in digamma(nu) - digamma(nu + x) are where float32
    rounding lands).  ``joint``: W's last row is pb and nu is exp-clamp."""
    d = lambda t: t.double()  # noqa: E731
    zc, zn, depth, l, W, x = map(d, (zc, zn, depth, l, W, x))
    RC, base = R + C, R + C + 1
    h = zc @ W[:RC] + W[RC]
    p = torch.exp(h - l)
    pe = p * torch.exp(W[base + Rn + 1]) if joint else p
    mu = pe * depth + 1e-4
    npre = zn @ W[base:base + Rn] + W[base + Rn]
    if joint:
        sp = torch.exp(npre)
        nu = sp.clamp(max=1e4) + 1e-4
        dsp = sp * (sp < 1e4)  # the true dnupre is 0 where nu is clamped
    else:
        sp = torch.nn.functional.softplus(npre)
        nu = sp.clamp(1e-4, 1e4) + 1e-4
        dsp = torch.sigmoid(npre)
    t = (x + nu) / (mu + nu)
    dls = (t.abs() + x / mu) * pe * depth
    dnu = (torch.digamma(nu).abs() + torch.digamma(nu + x).abs() + t
           + torch.log(nu).abs() + torch.log(mu + nu).abs() + 1.0)
    dnp = dnu * dsp
    return p, dls, dnp


def ratio(got, want, S):
    """(max |got - want|, max ratio to the tolerance 2e-5 S + 1e-7 max S)."""
    err = (got.double() - want.double()).abs()
    lim = 2e-5 * S + 1e-7 * S.abs().max() + 1e-30
    return err.max().item(), (err / lim).max().item()


def valgrad_bounds(x, zc, zn, depth, l, W, R, C, Rn, joint=False):
    """S of each of K2's gradient outputs (gout, rsum, u1, dzn): the
    same sums over the float64 magnitudes of their terms."""
    _, dls_m, dnp_m = grad_magnitudes(x, zc, zn, depth, l, W, R, C, Rn,
                                      joint)
    azc, azn, aW = zc.double().abs(), zn.double().abs(), W.double().abs()
    base = R + C + 1
    rows = [azc.T @ dls_m, dls_m.sum(0, True), azn.T @ dnp_m,
            dnp_m.sum(0, True)] + ([dls_m.sum(0, True)] if joint else [])
    return (torch.cat(rows), dls_m.sum(1, True), dls_m @ aW[:R].T,
            dnp_m @ aW[base:base + Rn].T)


def value_terms(x, zc, zn, depth, l, W, R, C, Rn, joint=False):
    """float64 NLL terms without lgamma(x + 1), at ``norm = l``: their sum
    is what a value-bearing K2 instance computes."""
    from mmvae_tpu_torch.ops import nb_step as ns

    with torch.no_grad():
        Wd, base = W.double(), R + C + 1
        return ns._terms(x.double(), ns._h(zc.double(), Wd, R + C)
                         - l.double(), ns._nupre(zn.double(), Wd, base, Rn),
                         depth.double(), False,
                         Wd[base + Rn + 1] if joint else None, joint)


def step_kernel_bounds(x, zc, zn, depth, W, widths) -> dict:
    """S of each output of K2 (grad-only), K6 (with lgamma(x + 1)) and K3
    (fed the plain K2's row sums), the normaliser from the plain K1:
    phase 6's bounds, at ``benchmarks.perm_probe.kernel_calls``'
    operands."""
    from mmvae_tpu_torch.ops import nb_step as ns

    R, C, Rn = widths
    lr = ns.lse_ref(zc, W, R, C)
    rs = ns.valgrad_ref(x, zc, zn, depth, lr, W, R, C, Rn)[1]
    base = R + C + 1
    with torch.no_grad():
        terms = ns._terms(x.double(), ns._h(zc.double(), W.double(), R + C)
                          - lr.double(), ns._nupre(zn.double(), W.double(),
                                                   base, Rn),
                          depth.double(), True)
    return {"nb_value": (terms.abs().sum(),),
            "nb_valgrad": valgrad_bounds(x, zc, zn, depth, lr, W, R, C, Rn),
            "nb_finish": finish_bounds(zc, lr, rs, W, R, C)}


def phase_train_kernels(card):
    from mmvae_tpu_torch.ops import enc_kernel as enc
    from mmvae_tpu_torch.ops import nb_step as ns

    g = torch.Generator(device=DEV).manual_seed(SEED + 3)
    worst = {k: 0.0 for k in ("count_encode_bwd", "nb_lse", "nb_value",
                              "nb_valgrad", "nb_finish")}
    main_times = {}
    log(f"[phase 6] training kernels vs plain (f32, TF32 off); {TRAIN_TOL}")
    for case, (B, D, dt, regime) in enumerate(REGIMES):
        x, zc, zn, depth, W, (R, C, Rn) = step_inputs(g, B, D, dt, regime)
        lr = ns.lse_ref(zc, W, R, C)
        g1 = torch.randn((B, R), generator=g, device=DEV)
        g2 = torch.randn((B, 2), generator=g, device=DEV)
        rs_ref = ns.valgrad_ref(x, zc, zn, depth, lr, W, R, C, Rn)[1]
        calls = {
            "count_encode_bwd": (lambda: enc.count_encode_bwd(x, g1, g2),
                                 lambda: enc.count_encode_bwd_ref(x, g1, g2)),
            "nb_lse": (lambda: ns.lse(zc, W, R, C),
                       lambda: ns.lse_ref(zc, W, R, C)),
            "nb_value": (lambda: ns.value(x, zc, zn, depth, lr, W, R, C, Rn),
                         lambda: ns.value_ref(x, zc, zn, depth, lr, W, R, C,
                                              Rn, True)),
            "nb_valgrad": (lambda: ns.valgrad(x, zc, zn, depth, lr, W, R, C,
                                              Rn),
                           lambda: ns.valgrad_ref(x, zc, zn, depth, lr, W, R,
                                                  C, Rn)),
            "nb_finish": (lambda: ns.finish(zc, lr, rs_ref, W, R, C),
                          lambda: ns.finish_ref(zc, lr, rs_ref, W, R, C)),
        }
        xd = x.double()
        bounds = {
            "count_encode_bwd": (g1.double().abs().T @ torch.log1p(xd),
                                 g2.double().abs().T @ xd.abs()),
            "nb_lse": (1.0 + lr.double().abs(),),
            **step_kernel_bounds(x, zc, zn, depth, W, (R, C, Rn)),
        }
        parts = []
        for name, (kern, plain) in calls.items():
            got, want = kern(), plain()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            again = kern()
            again = again if isinstance(again, tuple) else (again,)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"{name} not bitwise repeatable")
            e, q = 0.0, 0.0
            for gt, wt, S in zip(got, want, bounds[name]):
                ei, qi = ratio(gt, wt, S)
                e, q = max(e, ei), max(q, qi)
            if not q <= 1.0:
                raise AssertionError(f"{name} disagrees with plain at "
                                     f"{(B, D, dt, regime)}: err/tol {q:.3g}")
            worst[name] = max(worst[name], e)
            k_dev, _ = device_profile(kern, 20)
            p_dev, _ = device_profile(plain, 20)
            if case == MAIN_CASE:
                main_times[name] = (k_dev, p_dev)
            parts.append(f"{name} err {e:.3g} (err/tol {q:.3g}) kernel "
                         f"{k_dev:.4f} / plain {p_dev:.4f} ms")
        log(f"[phase 6] [{card}] B={B} D={D} {str(dt).replace('torch.', '')}"
            f" {regime}: " + "; ".join(parts))
    return worst, main_times


STATS_CASES = [(100, D_GENES, 5, 3, torch.int8),    # a training batch
               (1600, D_GENES, 2, 0, torch.int8),   # the serving launch
               (37, 1003, 5, 3, torch.int8),        # D off the tile width
               (37, 255, 5, 3, torch.int16),        # D at the tile edges
               (37, 256, 5, 3, torch.float32),
               (37, 257, 5, 0, torch.int8),
               (DP_M, D_GENES, 5, 3, torch.int8)]  # a rank's rows (37)


def joint_step_inputs(g, B, D, dtype, regime, widths=(2, 1, 1)):
    """``step_inputs`` for the joint model's variant: a zero covariate
    and covariate row (as the joint step hands the kernels), the pb row
    last, and a nu bias that puts exp(nu_pre) far above NU_HI in 0.5% of
    the columns (the clamp's mask)."""
    x, zc, zn, depth, W, (R, C, Rn) = step_inputs(g, B, D, dtype, regime,
                                                  widths)
    zc[:, R:] = 0.0
    W[R:R + C] = 0.0
    hot = torch.rand((D,), generator=g, device=DEV) < 0.005
    W[R + C + 1 + Rn] += hot.float() * 12.0  # exp(nu_pre) ~ 1.6e5
    pb = torch.randn((1, D), generator=g, device=DEV) * 0.3
    return x, zc, zn, depth, torch.cat([W, pb]).contiguous(), (R, C, Rn)


def phase_variant_kernels(card):
    """Phase 10: K4 with row stats, K6 and K2 in the joint model's
    pb / exp-nu variant, against their plain versions."""
    from mmvae_tpu_torch.ops import enc_kernel as enc
    from mmvae_tpu_torch.ops import nb_step as ns

    g = torch.Generator(device=DEV).manual_seed(SEED + 6)
    worst = {k: 0.0 for k in ("count_encode[stats]", "nb_value[pb,nu_exp]",
                              "nb_valgrad[pb,nu_exp]")}
    times = {}
    log(f"[phase 10] new kernel variants vs plain (f32, TF32 off); K4s: "
        f"{TOL}, stats tol 1e-5 * stat + 1e-6; K2: {TRAIN_TOL}; K6: both "
        f"held to the float64 sum, |kernel - f64| <= 2 |plain - f64| + "
        f"2.01e-5 * S")
    for M, D, r1, r2, dt in STATS_CASES:
        x = make_counts(g, M, D, dt)
        WL = torch.randn((r1, D), generator=g, device=DEV) * 0.1
        WX = (torch.randn((r2, D), generator=g, device=DEV) * 0.01
              if r2 else None)
        kern = lambda: enc.count_encode(x, WL, WX, want_stats=True)  # noqa
        plain = lambda: enc.count_encode_ref(x, WL, WX, want_stats=True)  # noqa
        got, want, again = kern(), plain(), kern()
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError("count_encode[stats] not bitwise repeatable")
        xf = x.double()
        e1, q1 = scaled_err(got[0], want[0],
                            xf.log1p().abs() @ WL.double().abs().T)
        e2, q2 = (scaled_err(got[1], want[1], xf.abs() @ WX.double().abs().T)
                  if r2 else (0.0, 0.0))
        e3, q3 = scaled_err(got[2], want[2], want[2].double().abs())
        q = max(q1, q2, q3)
        if not q <= 1.0:
            raise AssertionError(f"count_encode[stats] disagrees at "
                                 f"{(M, D, r1, r2, dt)}: err/tol {q:.3g}")
        worst["count_encode[stats]"] = max(worst["count_encode[stats]"], e1,
                                          e2, e3)
        k_dev, _ = device_profile(kern, 20)
        p_dev, _ = device_profile(plain, 20)
        times[("count_encode[stats]", M)] = (k_dev, p_dev)
        log(f"[phase 10] [{card}] count_encode[stats] M={M} D={D} r1={r1} "
            f"r2={r2} {str(dt).replace('torch.', '')}: max_abs_err hL "
            f"{e1:.3g} hX {e2:.3g} stats {e3:.3g} (err/tol {q:.3g}); device "
            f"time kernel {k_dev:.4f} ms, plain {p_dev:.4f} ms")
        if not r2:
            continue
        # K5 at the joint step's 5 + 3 cotangent columns
        g1 = torch.randn((M, r1), generator=g, device=DEV)
        g2 = torch.randn((M, r2), generator=g, device=DEV)
        kern = lambda: enc.count_encode_bwd(x, g1, g2)  # noqa: E731
        plain = lambda: enc.count_encode_bwd_ref(x, g1, g2)  # noqa: E731
        got, want, again = kern(), plain(), kern()
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError("count_encode_bwd not bitwise repeatable")
        e, q = 0.0, 0.0
        for gt, wt, S in zip(got, want, (g1.double().abs().T @ xf.log1p(),
                                         g2.double().abs().T @ xf.abs())):
            ei, qi = ratio(gt, wt, S)
            e, q = max(e, ei), max(q, qi)
        if not q <= 1.0:
            raise AssertionError(f"count_encode_bwd (5 + 3) disagrees: "
                                 f"err/tol {q:.3g}")
        k_dev, _ = device_profile(kern, 20)
        p_dev, _ = device_profile(plain, 20)
        times[("count_encode_bwd", M)] = (k_dev, p_dev)
        log(f"[phase 10] [{card}] count_encode_bwd M={M} D={D} r1={r1} "
            f"r2={r2}: err {e:.3g} (err/tol {q:.3g}; {TRAIN_TOL}); device "
            f"time kernel {k_dev:.4f} ms, plain {p_dev:.4f} ms")
    for case, (B, D, dt, regime) in enumerate(REGIMES):
        x, zc, zn, depth, W, (R, C, Rn) = joint_step_inputs(g, B, D, dt,
                                                            regime)
        lr = ns.lse_ref(zc, W, R, C)
        base = R + C + 1
        npre = zn @ W[base:base + Rn] + W[base + Rn]
        clamped = int((torch.exp(npre) >= 1e4).sum())
        if not clamped:
            raise AssertionError("no element of exp(nu_pre) reached NU_HI")
        calls = {
            "nb_value[pb,nu_exp]": (
                lambda: ns.value(x, zc, zn, depth, lr, W, R, C, Rn, True,
                                 True),
                lambda: ns.value_ref(x, zc, zn, depth, lr, W, R, C, Rn, True,
                                     True)),
            "nb_valgrad[pb,nu_exp]": (
                lambda: ns.valgrad(x, zc, zn, depth, lr, W, R, C, Rn, True),
                lambda: ns.valgrad_ref(x, zc, zn, depth, lr, W, R, C, Rn,
                                       True)),
        }
        with torch.no_grad():
            xd, Wd = x.double(), W.double()
            npd = ns._nupre(zn.double(), Wd, base, Rn)
            terms = ns._terms(xd, ns._h(zc.double(), Wd, R + C)
                              - lr.double(), npd, depth.double(), True,
                              Wd[base + Rn + 1], True)
        bounds = {"nb_valgrad[pb,nu_exp]": valgrad_bounds(
            x, zc, zn, depth, lr, W, R, C, Rn, joint=True)}
        parts = []
        for name, (kern, plain) in calls.items():
            got, want = kern(), plain()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            again = kern()
            again = again if isinstance(again, tuple) else (again,)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"{name} not bitwise repeatable")
            e, q, f64 = 0.0, 0.0, ""
            if name == "nb_value[pb,nu_exp]":
                # where nu sits at the clamp (1e4) both sides round the
                # cancelling ~1e5-sized parts of a term in float32: each
                # is held to the float64 sum, the kernel to twice the
                # plain version's error plus phase 6's tolerance
                ref = terms.sum()
                e_k = (got[0].double() - ref).abs().item()
                e_p = (want[0].double() - ref).abs().item()
                e = (got[0].double() - want[0].double()).abs().item()
                q = e_k / (2.0 * e_p + 2.01e-5 * terms.abs().sum().item())
                f64 = (f" [float64 sum {ref.item():.6g}: kernel off by "
                       f"{e_k:.4g}, plain by {e_p:.4g}]")
            else:
                for gt, wt, S in zip(got, want, bounds[name]):
                    ei, qi = ratio(gt, wt, S)
                    e, q = max(e, ei), max(q, qi)
            if not q <= 1.0:
                raise AssertionError(f"{name} disagrees with plain at "
                                     f"{(B, D, dt, regime)}: err/tol {q:.3g}"
                                     f"{f64}")
            worst[name] = max(worst[name], e)
            k_dev, _ = device_profile(kern, 20)
            p_dev, _ = device_profile(plain, 20)
            if case == MAIN_CASE:
                times[(name, B)] = (k_dev, p_dev)
            parts.append(f"{name} err {e:.3g} (err/tol {q:.3g}){f64} kernel "
                         f"{k_dev:.4f} / plain {p_dev:.4f} ms")
        log(f"[phase 10] [{card}] B={B} D={D} {str(dt).replace('torch.', '')}"
            f" {regime} ({clamped} elements at the NU_HI clamp): "
            + "; ".join(parts))
    return worst, {
        "count_encode[stats]": times[("count_encode[stats]",
                                      STATS_CASES[0][0])],
        "nb_value[pb,nu_exp]": times[("nb_value[pb,nu_exp]", B_TRAIN)],
        "nb_valgrad[pb,nu_exp]": times[("nb_valgrad[pb,nu_exp]", B_TRAIN)],
        "count_encode[stats] serving": times[("count_encode[stats]",
                                              STATS_CASES[1][0])],
        "count_encode_bwd joint": times[("count_encode_bwd",
                                         STATS_CASES[0][0])]}


FILT_CASES = [(100, D_GENES, 12, 3, torch.int8),    # a training batch
              (100, D_GENES, 12, 3, torch.int16),
              (100, D_GENES, 12, 3, torch.float32),
              (1600, D_GENES, 12, 1, torch.int8),   # the serving launch
              (100, D_GENES, 22, 3, torch.int8),    # K = 20: two launches
              (37, 1003, 12, 3, torch.int8),        # D off the tile width
              (37, 255, 12, 3, torch.int16),        # D at the tile edges
              (37, 256, 12, 1, torch.float32),
              (37, 257, 12, 3, torch.int8),
              (DP_M, D_GENES, 12, 3, torch.int8)]  # a rank's rows (37)


def phase_filt_kernels(card):
    """Phase 14: K4f (``count_encode`` with the annotation filter) against
    its plain version at the mixture's shapes, bitwise repeatable and
    invariant to row grouping; K5 at the mixture step's 12 + 3 rows."""
    from mmvae_tpu_torch.ops import enc_kernel as enc

    g = torch.Generator(device=DEV).manual_seed(SEED + 14)
    marker = torch.from_numpy(marker_label().any(axis=1).astype(
        np.float32)).to(DEV)
    covered = int(marker.sum().item())
    worst, times = 0.0, {}
    log(f"[phase 14] K4f count_encode[filt] vs plain (f32, TF32 off), "
        f"marker mask of {K_MIX} x 200 genes covering {covered} of "
        f"{D_GENES}; {TOL}, stats tol 1e-5 * stat + 1e-6")
    for M, D, r1, r2, dt in FILT_CASES:
        filt = marker[:D].contiguous()
        x = make_counts(g, M, D, dt)
        WL = torch.randn((r1, D), generator=g, device=DEV) * 0.1
        WX = torch.randn((r2, D), generator=g, device=DEV) * 0.01
        kern = lambda: enc.count_encode(x, WL, WX, want_stats=True,  # noqa
                                        filt=filt)
        plain = lambda: enc.count_encode_ref(x, WL, WX, want_stats=True,  # noqa
                                             filt=filt)
        got, want, again = kern(), plain(), kern()
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError("count_encode[filt] not bitwise repeatable")
        if torch.equal(got[2][:, 2:], got[2][:, :2]):
            raise AssertionError("filtered stats equal the plain stats")
        xf = x.double()
        e1, q1 = scaled_err(got[0], want[0],
                            xf.log1p().abs() @ WL.double().abs().T)
        e2, q2 = scaled_err(got[1], want[1], xf.abs() @ WX.double().abs().T)
        e3, q3 = scaled_err(got[2], want[2], want[2].double().abs())
        q = max(q1, q2, q3)
        if not q <= 1.0:
            raise AssertionError(f"count_encode[filt] disagrees at "
                                 f"{(M, D, r1, r2, dt)}: err/tol {q:.3g}")
        worst = max(worst, e1, e2, e3)
        k_dev, _ = device_profile(kern, 20)
        p_dev, _ = device_profile(plain, 20)
        times[(M, r1, dt)] = (k_dev, p_dev)
        log(f"[phase 14] [{card}] count_encode[filt] M={M} D={D} r1={r1} "
            f"r2={r2} {str(dt).replace('torch.', '')} "
            f"({len(enc.fwd_plan(D, r1, r2, True, True))} launch(es)): "
            f"max_abs_err hL {e1:.3g} hX {e2:.3g} stats {e3:.3g} (err/tol "
            f"{q:.3g}); device time kernel {k_dev:.4f} ms, plain "
            f"{p_dev:.4f} ms")
    # the serving launch: one launch over 1600 rows == 16 of 100, bitwise
    filt = marker
    x = make_counts(g, 1600, D_GENES, torch.int8)
    WL = torch.randn((12, D_GENES), generator=g, device=DEV) * 0.1
    WX = torch.randn((1, D_GENES), generator=g, device=DEV) * 0.01
    one = enc.count_encode(x, WL, WX, want_stats=True, filt=filt)
    parts = [enc.count_encode(x[i:i + 100], WL, WX, want_stats=True,
                              filt=filt) for i in range(0, 1600, 100)]
    torch.cuda.synchronize()
    for i, a in enumerate(one):
        if not torch.equal(a, torch.cat([p[i] for p in parts])):
            raise AssertionError("count_encode[filt]: 1 launch x 1600 rows "
                                 "!= 16 launches x 100 rows")
    # K5 at the mixture step's 12 + 3 cotangent columns
    x = make_counts(g, B_TRAIN, D_GENES, torch.int8)
    g1 = torch.randn((B_TRAIN, 12), generator=g, device=DEV)
    g2 = torch.randn((B_TRAIN, 3), generator=g, device=DEV)
    kern = lambda: enc.count_encode_bwd(x, g1, g2)  # noqa: E731
    plain = lambda: enc.count_encode_bwd_ref(x, g1, g2)  # noqa: E731
    got, want, again = kern(), plain(), kern()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError("count_encode_bwd not bitwise repeatable")
    xf = x.double()
    e, q = 0.0, 0.0
    for gt, wt, S in zip(got, want, (g1.double().abs().T @ xf.log1p(),
                                     g2.double().abs().T @ xf.abs())):
        ei, qi = ratio(gt, wt, S)
        e, q = max(e, ei), max(q, qi)
    if not q <= 1.0:
        raise AssertionError(f"count_encode_bwd (12 + 3) disagrees: "
                             f"err/tol {q:.3g}")
    k_dev, _ = device_profile(kern, 20)
    p_dev, _ = device_profile(plain, 20)
    log(f"[phase 14] [{card}] 1 launch x 1600 rows == 16 launches x 100 "
        f"rows, bitwise (hL, hX, stats); count_encode_bwd M={B_TRAIN} "
        f"D={D_GENES} r1=12 r2=3: err {e:.3g} (err/tol {q:.3g}; "
        f"{TRAIN_TOL}); device time kernel {k_dev:.4f} ms, plain "
        f"{p_dev:.4f} ms")
    return worst, times[(B_TRAIN, 12, torch.int8)], (k_dev, p_dev)


def model_and_step(kind: str):
    """(model, packed-step class) of the NB, vMF, joint or mixture model
    at the default architecture and D = 20,000 (the vMF-VAE with the
    auto covariate's width 1, the mixture with :func:`marker_label`)."""
    if kind == "vmf":
        from mmvae_tpu_torch.models.vmf import VMFVAE
        from mmvae_tpu_torch.ops.vmf_fast import VMFFastStep

        return VMFVAE(data_dim=D_GENES, covar_dim=1), VMFFastStep
    if kind == "mixture":
        from mmvae_tpu_torch.models.vmfnb_mixture import VMFNBMixtureVAE
        from mmvae_tpu_torch.ops.vmfnb_fast import VMFNBMixtureFastStep

        return VMFNBMixtureVAE(label=marker_label()), VMFNBMixtureFastStep
    if kind == "joint":
        from mmvae_tpu_torch.models.vmfnb import VMFNBVAE
        from mmvae_tpu_torch.ops.vmfnb_fast import VMFNBFastStep

        return VMFNBVAE(data_dim=D_GENES), VMFNBFastStep
    from mmvae_tpu_torch.models.nb import NBVAE
    from mmvae_tpu_torch.ops.nb_fast import NBFastStep

    return NBVAE(data_dim=D_GENES), NBFastStep


PHASE = {"nb": {"step": 7, "cli": 8, "full": 9},
         "joint": {"step": 11, "cli": 12, "full": 13},
         "mixture": {"step": 15, "cli": 16, "full": 17},
         "generic": {"step": 19, "cli": 20, "full": 21},
         "library": {"step": 23, "cli": 24, "full": 25},
         "vmf": {"step": 32, "cli": 33, "full": 34}}


def first_boot_grad(fast, q, x, c, rand, dtype=torch.float32):
    """{P, sv}: the packed gradient of the first boot loss, before any
    update, with every parameter and draw in ``dtype``."""
    qq = {k: v.detach().to(dtype).requires_grad_() for k, v in q.items()}
    loss = fast._loss(qq, x, c, rand["ridx"][0],
                      tuple(e[0].to(dtype) for e in rand["boot_eps"]),
                      fast._beta_for(0.0, x.device).to(dtype), False, True)
    return dict(zip(("P", "sv"), torch.autograd.grad(
        loss, (qq["P"], qq["sv"]))))


def anchored(k_row, p_row, ref_row, floor):
    """(kernel's and plain's worst error on a row against its float64
    reference, and the kernel's err/tol: tol = 2 x plain's + floor)."""
    e_k = (k_row.double() - ref_row).abs().max().item()
    e_p = (p_row.double() - ref_row).abs().max().item()
    return e_k, e_p, e_k / (2.0 * e_p + floor)


def phase_batch_step(card, kind="nb"):
    """Phase 7 (NB) / 11 (joint) / 15 (mixture): one batch step, kernel
    route against plain route, with the same draws.  The mixture's kappa
    row is held to the plain route's float64 step (see below)."""
    from mmvae_tpu_torch.ops.nb_fast import batch_rand
    from mmvae_tpu_torch.train.config import TrainingOptions

    tag = f"[phase {PHASE[kind]['step']}]"
    joint = kind != "nb"
    g = torch.Generator(device=DEV).manual_seed(
        SEED + {"nb": 4, "joint": 7, "mixture": 15}[kind])
    model, step_cls = model_and_step(kind)
    topt = TrainingOptions()
    params = random_params(model, DEV)
    x = make_counts(g, B_TRAIN, D_GENES, torch.int8)
    c = torch.ones((B_TRAIN, 1), device=DEV)
    out = {}
    for plain in (False, True):
        fast = step_cls(model, topt, plain=plain)
        rand = batch_rand(fast.draw_rand(
            torch.Generator(device=DEV).manual_seed(SEED + 5), 1,
            B_TRAIN), 0)
        q = fast.pack(params)
        po = fast.optimizer.init(q)
        grads = first_boot_grad(fast, q, x, c, rand)
        if plain and kind == "mixture":
            g64 = first_boot_grad(fast, q, x, c, rand, torch.float64)
            q64 = {k: v.double() for k, v in q.items()}
            rand64 = dict(rand, rep_eps=tuple(e.double() for e in
                                              rand["rep_eps"]),
                          boot_eps=tuple(e.double() for e in
                                         rand["boot_eps"]))
            _, po64, _ = fast.batch_step(q64, fast.optimizer.init(q64), x,
                                         c, 0.0, rand64)
        q2, po2, rep = fast.batch_step(q, po, x, c, 0.0, rand)
        torch.cuda.synchronize()
        out[plain] = (grads, q2, po2, rep)
    (gk, qk, ok, rk), (gp, qp, op, rp) = out[False], out[True]
    rep_err = abs(rk.item() - rp.item()) / abs(rp.item())
    if not rep_err <= 1e-5:
        raise AssertionError(f"batch step report: rel err {rep_err:.3g}")
    lines = [f"report {rk.item():.6f} vs {rp.item():.6f} (rel {rep_err:.2g},"
             f" tol 1e-5)"]
    rows = lambda t: t if t.dim() == 2 else t[None]  # noqa: E731
    for k in ("P", "sv"):
        # gradients: per row of P (one parameter row each; sv as one
        # row), tol 1e-4 of the row's largest gradient
        gk2, gp2 = rows(gk[k]), rows(gp[k])
        scale = gp2.abs().amax(1, keepdim=True)
        q_row = ((gk2 - gp2).abs() / (1e-4 * scale + 1e-12)).amax(1)
        anchor = kind == "mixture" and k == "P"
        kw = fast.rows.kappa_w if anchor else None
        if anchor:
            # the kappa row is a float32 cancellation in either route
            # (df / kappa against the Baricz midpoint, df = dd / 2 - 1;
            # measured: the plain route alone is off its float64 value by
            # several times 1e-4 of the row's scale): both routes are held
            # to the plain route's float64 step, the kernel's worst error
            # on the row to twice the plain route's plus the usual bound
            e_k, e_p, q_row[kw] = anchored(gk2[kw], gp2[kw], g64["P"][kw],
                                           1e-4 * scale[kw].item())
            lines.append(f"kappa row gradient vs float64: kernel off by "
                         f"{e_k:.3g}, plain by {e_p:.3g} (err/tol "
                         f"{q_row[kw].item():.3g})")
        q_g = q_row.max().item()
        worst_row = int(q_row.argmax())
        # Adam moments after the step: tol 1e-3 of the row's scale
        mom = []
        for m in ("mu", "nu"):
            a2, b2 = rows(ok[m][k]), rows(op[m][k])
            floor = 1e-3 * b2.abs().amax(1, keepdim=True)
            m_row = ((a2 - b2).abs() / (floor + 1e-30)).amax(1)
            if anchor:
                e_k, e_p, m_row[kw] = anchored(a2[kw], b2[kw],
                                               po64[m][k][kw],
                                               floor[kw].item())
                lines.append(f"kappa row Adam {m} vs float64: kernel off "
                             f"by {e_k:.3g}, plain by {e_p:.3g} (err/tol "
                             f"{m_row[kw].item():.3g})")
            mom.append(m_row.max().item())
            worst_row = (worst_row if m_row.max() <= 1.0
                         else int(m_row.argmax()))
        # params: Adam maps a gradient to about +-lr by its sign, so an
        # element whose gradient is below 1e-4 of its row's scale may
        # flip; the rest are held to 2e-5 (2% of lr).  In the joint model
        # so may an element whose final first moment is below 2% of its
        # row's scale, and the kappa row, whose gradient is mostly the
        # float32 cancellation of df / kappa against the Baricz midpoint
        # (df = 9,999).  No parameter bound holds those (a flip moves one
        # by up to 2 x nboot x lr, which no route can exceed): they are
        # counted and rest on the gradient and moment checks above
        small = (gp2.abs() < 1e-4 * scale)
        if joint:
            mu_p = rows(op["mu"][k])
            small |= mu_p.abs() < 2e-2 * mu_p.abs().amax(1, keepdim=True)
            if k == "P":
                small[fast.rows.kappa_w] = True
        dP = (qk[k] - qp[k]).reshape(gp2.shape).abs()
        q_p = (dP[~small].max().item() / 2e-5) if (~small).any() else 0.0
        if not (q_g <= 1.0 and max(mom) <= 1.0 and q_p <= 1.0):
            raise AssertionError(f"batch step {k}: grad err/tol {q_g:.3g}, "
                                 f"moments {mom[0]:.3g}/{mom[1]:.3g}, "
                                 f"params {q_p:.3g} (worst row "
                                 f"{worst_row})")
        lines.append(f"{k}: first-step grad err/tol {q_g:.3g}; Adam mu/nu "
                     f"err/tol {mom[0]:.3g}/{mom[1]:.3g}; params max diff "
                     f"{dP.max().item():.3g} ({int(small.sum())} elements "
                     f"with a near-zero gradient{' or moment' if joint else ''}"
                     f", held by the moment check only, max diff there "
                     f"{dP[small].max().item() if small.any() else 0:.3g}; "
                     f"elsewhere err/tol {q_p:.3g})")
    if int(ok["count"]) != 3 or int(op["count"]) != 3:
        raise AssertionError("Adam count after one batch step is not 3")
    log(f"{tag} [{card}] one {kind} batch step, kernel route vs plain "
        f"route, same draws: " + "; ".join(lines))


# ----------------------------------------------------------------------
# the generic step phases (18-21)
# ----------------------------------------------------------------------

ELBO_CASES = [(B_TRAIN, D_GENES, torch.int8, "counts<=7"),
              (B_TRAIN, D_GENES, torch.int8, "integer"),
              (B_TRAIN, D_GENES, torch.float32, "non-integer"),
              (B_TRAIN, 1003, torch.int8, "integer")]
ELBO_MAIN = 1  # int8 integer counts at B = 100, D = 20000: the main path
# K7 and K8 alone: one row (a single cluster), more rows than the card's
# 132 SMs, a D that is no multiple of K7's slice nor of K8's 4 columns,
# and a slice past a block's shared memory (K7's re-read instance)
ELBO_EXTRA = [(1, D_GENES, torch.int8, "integer"),
              (300, D_GENES, torch.int8, "integer"),
              (37, 5001, torch.int8, "integer"),
              (2, 160_000, torch.int8, "integer"),
              (DP_M, D_GENES, torch.int8, "integer")]  # a rank's rows (37)
# softplus(nu_pre) on both sides of each clamp edge (NU_LO = 1e-4,
# NU_HI = 1e4), far enough from it that float32 rounding cannot move an
# element across, and far outside it
EDGE_SOFTPLUS = (0.5e-4, 2e-4, 0.99e4, 1.01e4)


def edge_cells(B):
    """(row, column) of the first of the four EDGE_SOFTPLUS elements and
    of the pair far outside the clamp (rows 1 and 2; row 0 and the last
    row for B <= 2)."""
    return ((1, 0), (2, 0)) if B > 2 else ((0, 0), (B - 1, 4))


def elbo_inputs(g, B, D, dtype, regime):
    """K7 / K8 operands at the trainer's scales: counts in the named
    regime (integer cases with a run of 127s), logits of a few tenths,
    nu_pre ~ N(0, 1) with elements at and beyond both clamp edges
    (``edge_cells``), and library-size depth."""
    x = make_counts(g, B, D, dtype)
    if regime == "counts<=7":
        x = x.clamp(max=7)
    elif dtype != torch.float32:
        x[0, :50] = 127
    h = torch.randn((B, D), generator=g, device=DEV) * 0.5
    npre = torch.randn((B, D), generator=g, device=DEV)
    edges = torch.tensor(EDGE_SOFTPLUS, dtype=torch.float64)
    (ra, ca), (rb, cb) = edge_cells(B)
    # softplus^-1(s) = log(expm1(s)), which is s to float32 above 30
    npre[ra, ca:ca + 4] = torch.where(edges > 30, edges, torch.log(
        torch.expm1(edges.clamp(max=30)))).float().to(DEV)
    npre[rb, cb:cb + 2] = torch.tensor([-12.0, 2.0e4], device=DEV)
    depth = (x.float().sum(1, keepdim=True)
             * (0.5 + torch.rand((B, 1), generator=g, device=DEV)))
    return x, h, npre, depth.contiguous()


def elbo_magnitudes(x, h, npre, depth, lse, with_const):
    """float64 magnitudes of what K7 and K8 sum, each bounded by its own
    terms' magnitudes: (p, |terms| (B, D), |dmu| (B, D), |dnu| (B, D))."""
    from mmvae_tpu_torch.ops.nb_elbo import NU_HI, NU_LO

    x, h, npre, depth, lse = (t.double() for t in (x, h, npre, depth, lse))
    p = torch.exp(h - lse)
    mu = p * depth + 1e-4
    sp = torch.nn.functional.softplus(npre)
    nu = sp.clamp(NU_LO, NU_HI) + 1e-4
    lmn, lmu, lnu = (torch.log(v).abs() for v in (mu + nu, mu, nu))
    terms = (torch.lgamma(nu).abs() + torch.lgamma(nu + x).abs()
             + x * (lmn + lmu) + nu * (lmn + lnu))
    if with_const:
        terms = terms + torch.lgamma(x + 1.0).abs()
    t = (x + nu) / (mu + nu)
    dnu = ((torch.digamma(nu).abs() + torch.digamma(nu + x).abs() + t + lmn
            + lnu + 1.0) * torch.sigmoid(npre))
    return p, terms, t + x / mu, dnu


def phase_generic_kernels(card):
    """Phase 18: K7 (both instances), K8 and K2v against their plain
    versions; K2v's value against K6 and its gradients against K2; K7 and
    K8 alone at ELBO_EXTRA's shapes; K7's and K8's bits the same for
    int8, int16 and float32 storage of the same integer counts."""
    from mmvae_tpu_torch.ops import nb_elbo as ne
    from mmvae_tpu_torch.ops import nb_step as ns

    g = torch.Generator(device=DEV).manual_seed(SEED + 18)
    names = ("nb_elbo_fwd", "nb_elbo_fwd[const]", "nb_elbo_bwd",
             "nb_valgrad[value]")
    worst, times = {k: 0.0 for k in names}, {}
    log(f"[phase 18] K7, K8, K2v vs plain (f32, TF32 off); {TRAIN_TOL} "
        f"(scalars: S the sum over all terms; K7 rows and K8 elements: per "
        f"row or element); nu_pre at softplus {EDGE_SOFTPLUS} and beyond")

    def check(name, kern, plain, bounds, case, timed):
        got, want, again = kern(), plain(), kern()
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"{name} not bitwise repeatable")
        e, q = 0.0, 0.0
        for gt, wt, S in zip(got, want, bounds):
            ei, qi = ratio(gt, wt, S)
            e, q = max(e, ei), max(q, qi)
        if not q <= 1.0:
            raise AssertionError(f"{name} disagrees with plain at {case}: "
                                 f"err/tol {q:.3g}")
        worst[name] = max(worst[name], e)
        line = f"{name} err {e:.3g} (err/tol {q:.3g})"
        if not timed:
            return got, line, None
        k_dev, _ = device_profile(kern, 20)
        p_dev, _ = device_profile(plain, 20)
        return got, f"{line} kernel {k_dev:.4f} / plain {p_dev:.4f} ms", (
            k_dev, p_dev)

    for case, (B, D, dt, regime) in enumerate(ELBO_CASES + ELBO_EXTRA):
        x, h, npre, depth = elbo_inputs(g, B, D, dt, regime)
        tag = (B, D, str(dt).replace("torch.", ""), regime)
        plan = ne.elbo_plan(B, D)
        parts, t_case, fwds = [], {}, []
        for const in (False, True):
            name = "nb_elbo_fwd[const]" if const else "nb_elbo_fwd"
            lse = torch.logsumexp(h, 1, keepdim=True)
            p, terms, dmu_m, _ = elbo_magnitudes(x, h, npre, depth, lse,
                                                 const)
            dep = depth.double()
            bounds = (terms.sum(), 1.0 + lse.double().abs(),
                      (dmu_m * p * dep).sum(1, keepdim=True),
                      (dmu_m * p).sum(1, keepdim=True))
            fwd, line, t_case[name] = check(
                name, lambda: ne.elbo_fwd(x, h, npre, depth, const),
                lambda: ne.elbo_fwd_ref(x, h, npre, depth, const), bounds,
                tag, case == ELBO_MAIN)
            parts.append(line)
            fwds.append(fwd)
        _, lse, rs, _ = (t.contiguous() for t in fwds[0])
        p, _, dmu_m, dnu_m = elbo_magnitudes(x, h, npre, depth, lse, False)
        gv = torch.tensor(1.3, device=DEV)
        (dh, dnu), line, t_case["nb_elbo_bwd"] = check(
            "nb_elbo_bwd", lambda: ne.elbo_bwd(gv, x, h, npre, depth, lse, rs),
            lambda: ne.elbo_bwd_ref(gv, x, h, npre, depth, lse, rs),
            (1.3 * (dmu_m * p * depth.double() + p * rs.double().abs()),
             1.3 * dnu_m), tag, case == ELBO_MAIN)
        masked = int((dnu == 0).sum())
        # zero outside (NU_LO, NU_HI), every element (the float64
        # softplus of nu_pre, which no element sits near); inside, at
        # NU_HI, dnu is a float32 cancellation that may round to 0, so
        # only the NU_LO side is required to be nonzero (the elementwise
        # check holds the rest)
        sp64 = torch.nn.functional.softplus(npre.double())
        out_of_range = (sp64 <= ne.NU_LO) | (sp64 >= ne.NU_HI)
        (ra, ca), (rb, cb) = edge_cells(B)
        outside = torch.stack([dnu[ra, ca], dnu[ra, ca + 3], dnu[rb, cb],
                               dnu[rb, cb + 1]])
        if ((outside != 0).any() or dnu[ra, ca + 1] == 0
                or (dnu[out_of_range] != 0).any()):
            raise AssertionError(
                f"K8's clamp mask at the edges: "
                f"{dnu[ra, ca:ca + 4].tolist()}, "
                f"{dnu[rb, cb:cb + 2].tolist()}; "
                f"{int((dnu[out_of_range] != 0).sum())} nonzero outside")
        parts.append(line + f" ({masked} dnu zeroed by the clamp, "
                     f"{int(out_of_range.sum())} outside it)")
        if regime != "non-integer":
            # int16 and float32 storage of the same integer counts
            for dt2 in (torch.int16, torch.float32):
                x2 = x.to(dt2)
                same = [all(torch.equal(a, b) for a, b in zip(
                    ne.elbo_fwd(x2, h, npre, depth, const), fwds[const]))
                    for const in (False, True)]
                d2 = ne.elbo_bwd(gv, x2, h, npre, depth, lse, rs)
                same.append(torch.equal(d2[0], dh) and torch.equal(d2[1], dnu))
                if not all(same):
                    raise AssertionError(
                        f"K7 / K7c / K8 on {dt2} storage of {tag}'s counts "
                        f"differ from int8's: same bits {same}")
            parts.append("int8 == int16 == float32 storage bitwise")
        head = (f"[phase 18] [{card}] B={B} D={D} {tag[2]} {regime} (K7 "
                f"cluster {plan.cluster} x slice {plan.slice}, "
                f"{plan.instance}): ")
        if case >= len(ELBO_CASES):
            log(head + "; ".join(parts))
            continue
        # K2v on the step kernels' operands
        xs, zc, zn, sdep, W, (R, C, Rn) = step_inputs(g, B, D, dt, regime)
        if regime != "counts<=7" and dt != torch.float32:
            xs[0, :50] = 127
        lr = ns.lse_ref(zc, W, R, C)
        vS = value_terms(xs, zc, zn, sdep, lr, W, R, C, Rn).abs().sum()
        kv, line, t_case["nb_valgrad[value]"] = check(
            "nb_valgrad[value]",
            lambda: ns.valgrad(xs, zc, zn, sdep, lr, W, R, C, Rn,
                               need_value=True),
            lambda: ns.valgrad_ref(xs, zc, zn, sdep, lr, W, R, C, Rn,
                                   need_value=True),
            (*valgrad_bounds(xs, zc, zn, sdep, lr, W, R, C, Rn), vS), tag,
            case == ELBO_MAIN)
        k2 = ns.valgrad(xs, zc, zn, sdep, lr, W, R, C, Rn)
        k6 = ns.value(xs, zc, zn, sdep, lr, W, R, C, Rn, with_const=False)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(kv[:4], k2)):
            raise AssertionError("K2v's gradient outputs differ from K2's")
        _, q6 = ratio(kv[4], k6, vS)
        if not q6 <= 1.0:
            raise AssertionError(f"K2v value vs K6: err/tol {q6:.3g}")
        parts.append(line + f"; value {kv[4].item():.7g} vs K6 "
                     f"{k6.item():.7g} (err/tol {q6:.3g}); gradients == K2 "
                     f"bitwise")
        if case == ELBO_MAIN:
            times.update(t_case)
        log(head + "; ".join(parts))
    return worst, times


# route label -> (architecture, step options, the README's K2v trainer)
GENERIC_ROUTES = {
    "v2 step kernels, --mean_encoding 16": (dict(mean_encoding=(16,)), {},
                                            False),
    "v1 ELBO kernels, --mean_decoding 16": (dict(mean_decoding=(16,)), {},
                                            False),
    "v1 ELBO kernels, --no_fused_step": ({}, dict(fused_step=False), False),
    "README fused_step_boot (K2v)": ({}, {}, True),
}


def generic_trainer(model, topt, plain=False, readme=False):
    """The step ``nb_vae`` builds for ``model`` and ``topt``
    (``make_step``), or with ``readme`` the README's library trainer:
    the generic ``Trainer`` with ``fused_step_report`` and the
    value-bearing ``fused_step_boot`` (K2v)."""
    from mmvae_tpu_torch.cli.nb_vae import make_step
    from mmvae_tpu_torch.ops.losses import nb_loss
    from mmvae_tpu_torch.train.loop import Trainer

    if not readme:
        return make_step(model, topt, plain=plain)[0]
    return Trainer(
        lambda p, x, c, e, t: model.forward(p, x, c, e, t, plain=plain),
        lambda x, out, b: nb_loss(x, *out, b), topt,
        eps_widths=(model.mean_latent, model.overdisp_latent),
        report_loss_override=lambda p, x, c, e, b: model.fused_step_report(
            p, x, c, e, b, plain=plain),
        boot_loss_override=lambda p, x, c, e, b: model.fused_step_boot(
            p, x, c, e, b, need_value=True, plain=plain))


def _route_step(tr, params, x, c, rand):
    """(first boot loss, its gradient per leaf, and one batch step's
    params, Adam state and report) of the generic trainer ``tr``."""
    from mmvae_tpu_torch.ops.nb_fast import tree_leaves, tree_unflatten

    leaves = [v.detach().requires_grad_() for v in tree_leaves(params)]
    r = rand["ridx"][0]
    loss = tr._boot(tree_unflatten(params, leaves), x.index_select(0, r),
                    c.index_select(0, r),
                    tuple(e[0] for e in rand["boot_eps"]),
                    tr._beta_for(0.0, x.device))
    grads = torch.autograd.grad(loss, leaves)
    p2, o2, rep = tr.batch_step(params, tr.optimizer.init(params), x, c,
                                0.0, rand)
    return loss.detach(), grads, p2, o2, rep


def _cpu64(tree):
    """A tree (or tuple) of tensors on the CPU, floats in float64."""
    if isinstance(tree, dict):
        return {k: _cpu64(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_cpu64(v) for v in tree)
    t = tree.detach().cpu()
    return t.double() if t.is_floating_point() else t


def check_generic_route(card, tag, label, make, params, x, c,
                        value_boot=False, joint=False):
    """One generic batch step, kernel route (``make(False)``) against
    plain route (``make(True)``) on the same draws: the first boot loss
    and its gradient per leaf and row (tol 1e-4 of the row's largest
    gradient), the Adam moments after the step (1e-3 of the row's scale),
    the parameters (2e-5, elements with a gradient below 1e-4 of their
    row's scale held by the moment check only) and the report (rel 1e-5);
    ``value_boot``: the boot loss is a value, held at rel 1e-5.

    ``joint`` (the vMF+NB models): the leaves without a D axis (the
    packed steps' small vector ``sv``) are one row, as phases 11 and 15
    hold ``sv``; the ``ln_kappa`` leaves' gradients are a float32
    cancellation (``df / kappa`` against the Baricz midpoint) in either
    route, so both are held to the float64 step (the kernel route's plain
    versions in float64 on the CPU), the kernel's worst error to twice
    the plain route's plus the usual bound, as phase 15 holds the
    mixture's kappa row; their parameters, and those whose final first
    moment is below 2% of the row's scale, rest on the gradient and
    moment checks (phase 11's rule).  The other parameters are held to
    the float64 step element by element, the kernel route's error to
    twice the plain route's plus 2e-5: after the first update a
    parameter whose moment is small against its row's can take another
    float32 path in either route (measured: in the plain route, 2% of lr
    from the float64 step where the kernel route was 0.3%)."""
    from mmvae_tpu_torch.ops.nb_fast import batch_rand, tree_leaves

    def rows(t):
        """A leaf as rows over its D-sized axis (weights are stored (in,
        out), so the encoder's (D, H) first layers turn over): the packed
        step's parameter rows, which phase 7 holds row by row."""
        if t.dim() == 1:
            return t.reshape(1, -1)
        if t.dim() == 3:
            return t.reshape(-1, t.shape[-1])
        return t.T if t.shape[0] == D_GENES else t

    out = {}
    for plain in (False, True):
        tr = make(plain)
        rand = batch_rand(tr.draw_rand(
            torch.Generator(device=DEV).manual_seed(SEED + 5), 1, B_TRAIN), 0)
        out[plain] = _route_step(tr, params, x, c, rand)
    if joint:
        rand64 = {k: _cpu64(v) for k, v in rand.items()}
        ref64 = _route_step(make(False), _cpu64(params), x.cpu(), c.cpu(),
                            rand64)
    (lk, gk, pk, ok, rk), (lp, gp, pp, op, rp) = out[False], out[True]
    rep_err = abs(rk.item() - rp.item()) / abs(rp.item())
    if not rep_err <= 1e-5:
        raise AssertionError(f"{label}: report rel err {rep_err:.3g}")
    lines = [f"report {rk.item():.6f} vs {rp.item():.6f} (rel "
             f"{rep_err:.2g})"]
    if value_boot:
        # the value-bearing boot loss is the value, not 0.0
        l_err = abs(lk.item() - lp.item()) / abs(lp.item())
        if not l_err <= 1e-5:
            raise AssertionError(f"{label}: boot loss rel err {l_err:.3g}")
        lines.append(f"first boot loss {lk.item():.6f} vs {lp.item():.6f} "
                     f"(rel {l_err:.2g})")
    # joint: the leaves without a D axis share one row scale
    sv = [i for i, t in enumerate(gp) if joint and D_GENES not in t.shape]

    def scale_of(leaves, i):
        if i in sv:
            return max(leaves[j].abs().max() for j in sv).reshape(1, 1)
        return rows(leaves[i]).abs().amax(1, keepdim=True)

    q_g = q_m = q_p = 0.0
    n_small, worst_leaf, worst_mom, worst_par = 0, None, None, None
    names = leaf_names(params)
    for i, (a, b) in enumerate(zip(gk, gp)):
        a2, b2 = rows(a), rows(b)
        scale = scale_of(gp, i)
        anchor = joint and names[i].startswith("ln_kappa.")
        if anchor:
            ref = rows(ref64[1][i]).to(DEV)
            e_k, e_p, q_i = anchored(a2, b2, ref, 1e-4 * scale.max().item())
            lines.append(f"{names[i]} gradient vs float64: kernel off by "
                         f"{e_k:.3g}, plain by {e_p:.3g} (err/tol "
                         f"{q_i:.3g})")
        else:
            q_i = ((a2 - b2).abs() / (1e-4 * scale + 1e-12)).max().item()
        if q_i > q_g:
            q_g, worst_leaf = q_i, names[i]
        for m in ("mu", "nu"):
            ma = rows(tree_leaves(ok[m])[i])
            mb = rows(tree_leaves(op[m])[i])
            floor = 1e-3 * scale_of(tree_leaves(op[m]), i)
            if anchor:
                ref = rows(tree_leaves(ref64[3][m])[i]).to(DEV)
                q_i = anchored(ma, mb, ref, floor.max().item())[2]
            else:
                q_i = ((ma - mb).abs() / (floor + 1e-30)).max().item()
            if q_i > q_m:
                q_m, worst_mom = q_i, f"{m} {names[i]}"
        small = b2.abs() < 1e-4 * scale
        if joint:
            mu_p = rows(tree_leaves(op["mu"])[i])
            small |= mu_p.abs() < 2e-2 * scale_of(tree_leaves(op["mu"]), i)
            small |= anchor
        n_small += int(small.sum())
        pk_i, pp_i = rows(tree_leaves(pk)[i]), rows(tree_leaves(pp)[i])
        if joint:
            p64 = rows(tree_leaves(ref64[2])[i]).to(DEV)
            dP = (pk_i.double() - p64).abs() / (
                2.0 * (pp_i.double() - p64).abs() + 2e-5)
        else:
            dP = (pk_i - pp_i).abs() / 2e-5
        if (~small).any() and dP[~small].max().item() > q_p:
            q_p = dP[~small].max().item()
            j = int(torch.where(small, 0.0, dP).argmax())
            at = lambda t: rows(t).reshape(-1)[j].item()  # noqa: E731
            worst_par = (f"{names[i]} [{j}]: kernel {at(pk_i):.7g}, "
                         f"plain {at(pp_i):.7g}")
            if joint:
                worst_par += f", float64 {at(p64):.7g}"
    if not (q_g <= 1.0 and q_m <= 1.0 and q_p <= 1.0):
        raise AssertionError(f"{label}: grad err/tol {q_g:.3g} (worst "
                             f"leaf {worst_leaf}), moments {q_m:.3g} "
                             f"({worst_mom}), params {q_p:.3g} "
                             f"({worst_par})")
    if int(ok["count"]) != 3 or int(op["count"]) != 3:
        raise AssertionError(f"{label}: Adam count is not 3")
    held = "a near-zero gradient" + (" or moment, or on ln_kappa"
                                     if joint else "")
    lines.append(f"{len(gk)} leaves: first-step grad err/tol {q_g:.3g} "
                 f"({worst_leaf}); Adam moments err/tol {q_m:.3g} "
                 f"({worst_mom}); params err/tol {q_p:.3g} ({worst_par}; "
                 f"{n_small} elements with {held} held by the gradient "
                 f"and moment checks only)")
    log(f"{tag} [{card}] one generic batch step ({label}), kernel route vs "
        f"plain route, same draws: " + "; ".join(lines))


def phase_generic_step(card):
    """Phase 19: one generic batch step per route of the NB model, kernel
    route against plain route (:func:`check_generic_route`)."""
    from mmvae_tpu_torch.models.nb import NBVAE
    from mmvae_tpu_torch.train.config import TrainingOptions

    g = torch.Generator(device=DEV).manual_seed(SEED + 19)
    x = make_counts(g, B_TRAIN, D_GENES, torch.int8)
    c = torch.ones((B_TRAIN, 1), device=DEV)
    for label, (arch, flags, readme) in GENERIC_ROUTES.items():
        model = NBVAE(data_dim=D_GENES, **arch)
        check_generic_route(
            card, "[phase 19]", label,
            lambda plain: generic_trainer(model, TrainingOptions(**flags),
                                          plain, readme),
            random_params(model, DEV), x, c, value_boot=readme)


def leaf_names(tree: dict, prefix: str = "") -> list[str]:
    """Dotted names of a nested dict's leaves in ``tree_leaves`` order."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        out.extend(leaf_names(v, f"{prefix}{k}.") if isinstance(v, dict)
                   else [prefix + k])
    return out


def plain_encode_hidden(params, x, names):
    """Independent plain reference of ``encode_mu`` for a hidden-layer
    encoder (no ReLU): the unfolded standardization, as the JAX model
    writes it."""
    sd = torch.nn.functional.softplus(params["ln_x_sd"]) + 1e-4
    h = (torch.log1p(x.float()) - params["x_mean"]) / sd
    for n in names:
        h = h @ params[n]["weight"] + params[n]["bias"]
    lin = lambda n: h @ params[n]["weight"] + params[n]["bias"]  # noqa: E731
    return (lin("mu_representation_mean"),
            lin("mu_representation_logvariance").clamp(-4.0, 4.0))


def library_epoch(card, tag, label, tmp, mtx, model, trainer, topt, path):
    """One epoch of a library trainer (the JAX README's entry point, not
    a CLI) through ``train_vae_model`` on the synthetic matrix, with every
    launch counter reset just before and read just after; every kernel
    of ``path`` must launch.  Returns the launches."""
    from mmvae_tpu_torch.data.block import MtxMemoryBlock, create_ones_like
    from mmvae_tpu_torch.io.index import build_mmutil_index
    from mmvae_tpu_torch.train.loop import train_vae_model

    data = MtxMemoryBlock(mtx, mtx + ".index", B_TRAIN, count_dtype="auto")
    ones = os.path.join(tmp, "ones.mtx.gz")
    if not os.path.exists(ones):
        create_ones_like(data, ones)
        build_mmutil_index(ones, ones + ".index")
    covar = MtxMemoryBlock(ones, ones + ".index", B_TRAIN)
    covar.auto_ones = True
    reset_launches()
    tee = _Tee(sys.stderr)
    with contextlib.redirect_stderr(tee):
        _, scores = train_vae_model(
            trainer, None, data, covar, topt,
            model.init(torch.Generator().manual_seed(SEED), device=DEV), DEV)
    launches = read_launches()
    if min(launches[k] for k in path) < 1 or not np.isfinite(scores).all():
        raise AssertionError(f"{label}: scores {scores}, launches "
                             f"{launches}")
    log(f"{tag} [{card}] {label}, 1 epoch: score {scores}; launches "
        f"{ {k: launches[k] for k in path} }; "
        + [ln.split("] ", 1)[-1] for ln in tee.buf.getvalue().splitlines()
           if "cells/sec" in ln][-1])
    return launches


def phase_generic_cli(card, tmp, mtx):
    """Phase 20: ``nb_vae`` on the generic step (the main path of K7 and
    K8) with hidden layers, recording, a checkpoint and ``--resume``;
    ``--no_fused_step`` and ``--no_fused`` once each; the README's library
    trainer with K2v (the main path of K2v) through ``train_vae_model``;
    ``encode --model nb`` on the hidden-layer checkpoint.  Every launch
    counter is reset just before each run and read just after."""
    from mmvae_tpu_torch.cli import encode, nb_vae
    from mmvae_tpu_torch.models.nb import NBVAE, params_from_numpy
    from mmvae_tpu_torch.train.checkpoint import load_checkpoint
    from mmvae_tpu_torch.train.config import TrainingOptions
    from mmvae_tpu_torch.train.recorder import flatten_params

    tag = "[phase 20]"
    hidden = ["--mean_encoding", "16", "--mean_decoding", "16"]
    args = ["--mtx", mtx, "--batch_size", str(B_TRAIN), "--device", DEV]
    out = os.path.join(tmp, "gen")
    ck = out + "_ckpt"

    reset_launches()
    t0 = time.time()
    err = run_cli(nb_vae, args + hidden + ["--recording", "2", "--out", out,
                                           "--max_epoch", "2",
                                           "--checkpoint_dir", ck])
    wall = time.time() - t0
    launches = read_launches()
    route = step_line(err)
    if "v1 ELBO kernels" not in route or min(
            launches[k] for k in GENERIC_PATH) < 1:
        raise AssertionError(f"nb_vae {' '.join(hidden)}: route {route!r}, "
                             f"launches {launches}")
    scores = np.loadtxt(out + ".scores.gz", ndmin=1)
    if scores.shape != (2,) or not np.isfinite(scores).all():
        raise AssertionError(f"scores.gz: {scores}")
    model = NBVAE(data_dim=D_GENES, mean_encoding=(16,), mean_decoding=(16,))
    names = flatten_params(model.init(torch.Generator().manual_seed(0)))
    want = {f"{out}_1.mu_mean.gz": (N_CLI, 2),
            f"{out}_1.mu_lnvar.gz": (N_CLI, 2)}
    want.update({f"{out}_1_{k}.gz": v.shape for k, v in names.items()})
    for path, shape in want.items():
        a = np.loadtxt(path, ndmin=2)
        if a.shape != (shape if len(shape) == 2 else (shape[0], 1)) or \
                not np.isfinite(a).all():
            raise AssertionError(f"{path}: shape {a.shape}, want {shape}")
    rates = [ln.split("] ", 1)[-1] for ln in err.splitlines()
             if "cells/sec" in ln]
    log(f"{tag} [{card}] nb_vae {' '.join(hidden)}, {N_CLI} x {D_GENES}, 2 "
        f"epochs: step {route!r}; scores {scores.tolist()}; {len(want)} "
        f"recording artifacts with the JAX CLI's names and shapes; kernel "
        f"launches { {k: launches[k] for k in GENERIC_PATH} }; epochs: "
        f"{' | '.join(rates)}; CLI wall {wall:.2f}s")
    err = run_cli(nb_vae, args + hidden + ["--out", out + "_r",
                                           "--max_epoch", "3", "--resume",
                                           ck])
    s3 = np.loadtxt(out + "_r.scores.gz", ndmin=1)
    if (s3.shape != (3,) or not np.array_equal(s3[:2], scores)
            or not np.isfinite(s3).all() or "Resumed from" not in err):
        raise AssertionError(f"resume: scores {s3}")
    log(f"{tag} [{card}] --resume from the checkpoint ran epoch 3: scores "
        f"{s3.tolist()}")

    for flags, expect, path in (
            (["--no_fused_step"], "v1 ELBO kernels", GENERIC_PATH),
            (["--no_fused"], "forward + nb_loss",
             ["count_encode", "count_encode_bwd"])):
        reset_launches()
        err = run_cli(nb_vae, args + flags + [
            "--out", os.path.join(tmp, "g" + flags[0][2:]), "--max_epoch",
            "1"])
        n = read_launches()
        route = step_line(err)
        elbo = [k for k in GENERIC_PATH if k.startswith("nb_elbo")]
        ran = {k: n[k] for k in path}
        if (expect not in route or min(ran.values()) < 1
                or (expect == "forward + nb_loss"
                    and any(n[k] for k in elbo))):
            raise AssertionError(f"nb_vae {flags[0]}: route {route!r}, "
                                 f"launches {n}")
        log(f"{tag} [{card}] nb_vae {flags[0]}, 1 epoch: step {route!r}; "
            f"launches {ran}; "
            + [ln.split("] ", 1)[-1] for ln in err.splitlines()
               if "cells/sec" in ln][-1])

    # the README's library trainer: K2v on its main path
    lib_model = NBVAE(data_dim=D_GENES)
    topt = TrainingOptions(max_epoch=1)
    readme_launches = library_epoch(
        card, tag, "README library trainer (fused_step_report / "
        "fused_step_boot, K2v)", tmp, mtx, lib_model,
        generic_trainer(lib_model, topt, readme=True), topt, README_PATH)

    # serving the hidden-layer checkpoint
    enc_out = os.path.join(tmp, "genc")
    reset_launches()
    run_cli(encode, ["--model", "nb", "--mtx", mtx, "--checkpoint", ck,
                     "--batch_size", str(B_TRAIN), "--device", DEV, "--out",
                     enc_out, *hidden])
    enc_launches = read_launches()["count_encode"]
    res = [np.loadtxt(f"{enc_out}.mu_{k}.gz", ndmin=2)
           for k in ("mean", "lnvar")]
    params = params_from_numpy(load_checkpoint(ck, model)[0], DEV)
    with torch.inference_mode():
        xd = torch.from_numpy(read_mtx_dense(mtx)).to(DEV)
        ref = [t.double().cpu().numpy() for t in plain_encode_hidden(
            params, xd, model._enc_names())]
    worst = 0.0
    for got, w in zip(res, ref):
        if got.shape != (N_CLI, 2) or not np.isfinite(got).all():
            raise AssertionError(f"bad hidden-layer encode output "
                                 f"{got.shape}")
        # the fold reorders float32 sums over 20,000 genes: 1e-4 of the
        # output's scale, plus the %g text rounding (6 digits)
        lim = 1e-4 * np.abs(w).max() + 1e-5 * np.abs(w)
        worst = max(worst, float(np.max(np.abs(got - w) / lim)))
    if not worst <= 1.0 or enc_launches < 1:
        raise AssertionError(f"hidden-layer encode vs plain: err/tol "
                             f"{worst:.3g}, {enc_launches} launches")
    log(f"{tag} [{card}] encode --model nb {' '.join(hidden)}: "
        f"{enc_launches} count_encode launches; outputs ({N_CLI}, 2) match "
        f"the plain unfolded encoder (err/tol {worst:.3g}; tol 1e-4 * "
        f"max|ref| + 1e-5 * |ref|)")
    return launches, readme_launches


# ----------------------------------------------------------------------
# the vMF+NB generic step phases (22-25)
# ----------------------------------------------------------------------

K2PV_CASES = [(B_TRAIN, D_GENES, torch.int8, "counts<=7"),
              (B_TRAIN, D_GENES, torch.int8, "integer"),
              (B_TRAIN, D_GENES, torch.float32, "non-integer"),
              (B_TRAIN, 1003, torch.int8, "integer")]
K2PV_MAIN = 1  # int8 integer counts at B = 100, D = 20000: the main path
# exp(nu_pre) on both sides of the NU_HI clamp edge, far enough from it
# that float32 rounding cannot move an element across
EDGE_EXP = (0.9e4, 0.99e4, 1.01e4, 1.1e4)


def phase_k2pv(card):
    """Phase 22: K2pv (``valgrad(joint=True, need_value=True)``) against
    its plain version: bitwise repeatability, the gradient outputs within
    the training tolerance and equal to K2p's bitwise, and the value held
    to the float64 sum as K6p is (kernel error <= 2 x plain's + 2.01e-5 S)
    and to K6p's ``with_const=False`` value; device times at the main
    path's case."""
    from mmvae_tpu_torch.ops import nb_step as ns

    g = torch.Generator(device=DEV).manual_seed(SEED + 22)
    name = "nb_valgrad[pb,nu_exp,value]"
    worst, times = 0.0, None
    log(f"[phase 22] K2pv vs plain (f32, TF32 off); gradients: {TRAIN_TOL};"
        f" value: |kernel - f64| <= 2 |plain - f64| + 2.01e-5 * S; "
        f"exp(nu_pre) at {EDGE_EXP} and far beyond NU_HI")
    for case, (B, D, dt, regime) in enumerate(K2PV_CASES):
        x, zc, zn, depth, W, (R, C, Rn) = joint_step_inputs(g, B, D, dt,
                                                            regime)
        if regime == "integer":
            x[0, :50] = 127 if dt == torch.int8 else 32767
        base = R + C + 1
        W[base:base + Rn, :4] = 0.0
        W[base + Rn, :4] = torch.log(torch.tensor(EDGE_EXP, device=DEV))
        lr = ns.lse_ref(zc, W, R, C)
        npre = zn @ W[base:base + Rn] + W[base + Rn]
        clamped = int((torch.exp(npre) >= 1e4).sum())
        terms = value_terms(x, zc, zn, depth, lr, W, R, C, Rn, joint=True)
        bounds = valgrad_bounds(x, zc, zn, depth, lr, W, R, C, Rn, joint=True)
        kern = lambda: ns.valgrad(x, zc, zn, depth, lr, W, R, C, Rn,  # noqa
                                  True, True)
        plain = lambda: ns.valgrad_ref(x, zc, zn, depth, lr, W, R, C,  # noqa
                                       Rn, True, True)
        got, want, again = kern(), plain(), kern()
        k2p = ns.valgrad(x, zc, zn, depth, lr, W, R, C, Rn, True)
        k6p = ns.value(x, zc, zn, depth, lr, W, R, C, Rn, False, True)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"{name} not bitwise repeatable")
        if not all(torch.equal(a, b) for a, b in zip(got[:4], k2p)):
            raise AssertionError("K2pv's gradient outputs differ from K2p's")
        e, q = 0.0, 0.0
        for gt, wt, S in zip(got[:4], want[:4], bounds):
            ei, qi = ratio(gt, wt, S)
            e, q = max(e, ei), max(q, qi)
        ref, S = terms.sum(), terms.abs().sum().item()
        e_k = (got[4].double() - ref).abs().item()
        e_p = (want[4].double() - ref).abs().item()
        e_6 = (k6p.double() - ref).abs().item()
        q_v = e_k / (2.0 * e_p + 2.01e-5 * S)
        q_6 = (got[4].double() - k6p.double()).abs().item() / (2.01e-5 * S)
        if not (q <= 1.0 and q_v <= 1.0 and q_6 <= 1.0):
            raise AssertionError(
                f"{name} disagrees at {(B, D, dt, regime)}: gradients "
                f"err/tol {q:.3g}, value vs float64 {q_v:.3g} (kernel off "
                f"by {e_k:.4g}, plain by {e_p:.4g}), vs K6p {q_6:.3g}")
        worst = max(worst, e, (got[4] - want[4]).abs().item())
        line = (f"gradients err {e:.3g} (err/tol {q:.3g}), == K2p bitwise; "
                f"value {got[4].item():.8g} [float64 sum {ref.item():.8g}: "
                f"kernel off by {e_k:.4g}, plain by {e_p:.4g}, K6p by "
                f"{e_6:.4g}; err/tol {q_v:.3g}, vs K6p {q_6:.3g}]")
        if case == K2PV_MAIN:
            k_dev, _ = device_profile(kern, 20)
            p_dev, _ = device_profile(plain, 20)
            k2p_dev, _ = device_profile(
                lambda: ns.valgrad(x, zc, zn, depth, lr, W, R, C, Rn, True),
                20)
            times = (k_dev, p_dev)
            line += (f"; device time kernel {k_dev:.4f} / plain {p_dev:.4f} "
                     f"ms (K2p {k2p_dev:.4f})")
        log(f"[phase 22] [{card}] B={B} D={D} {str(dt).replace('torch.', '')}"
            f" {regime} ({clamped} elements at the NU_HI clamp): {line}")
    return {name: worst}, {name: times}


VALGRAD_BS = (1, 37, DP_M, 100, 1600)  # DP_M: a data-parallel rank's rows
# D_GENES // 2: a rank's features under --tensor_parallel 2 (phases 39-41)
VALGRAD_DS = (255, 256, 257, 1003, D_GENES // 2, D_GENES)
VALGRAD_WIDTHS = ((2, 1, 1), (4, 2, 3))  # the compile-time instance, a general one
# the widths the reference trains past 16 stacked rows (R, C, Rn):
# nb_vae --mean_latent 13 with one covariate (T = 17), a covariate file of
# 12 columns (17), the joint model with 11 overdispersion latents and pb
# (17), (16, 5, 1) (24), covariate files of 40 (45) and 123 columns
# (128); held on a subset of the (B, D) grid (a ragged D and the main
# path's), in the three lgamma regimes
WIDE_WIDTHS = ((13, 1, 1), (2, 12, 1), (2, 1, 11), (16, 5, 1), (2, 40, 1),
               (2, 123, 1))
WIDE_BS = (37, B_TRAIN)
WIDE_DS = (257, D_GENES)


def width_cases(bs, ds, widths):
    """(B, D, widths) of the grid bs x ds x widths, then the wide widths
    on the WIDE_BS x WIDE_DS subset."""
    return ([(B, D, w) for B in bs for D in ds for w in widths]
            + [(B, D, w) for B in WIDE_BS for D in WIDE_DS
               for w in WIDE_WIDTHS])


def count_kinds(g, x8, B, D, wide):
    """The storages and regimes a case runs: integer counts as int8,
    int16 and float32 (bitwise equal), non-integer float32 and, for the
    wide widths, int8 counts <= 7 (the select-product regime)."""
    kinds = {"int8": x8, "int16": x8.to(torch.int16), "float32": x8.float(),
             "non-integer": make_counts(g, B, D, torch.float32)}
    if wide:
        kinds["counts<=7"] = x8.clamp(max=7)
    return kinds
# name, joint, need_value
VALGRAD_VARIANTS = (("nb_valgrad", False, False),
                    ("nb_valgrad[pb,nu_exp]", True, False),
                    ("nb_valgrad[value]", False, True),
                    ("nb_valgrad[pb,nu_exp,value]", True, True))


def phase_valgrad_cases(card):
    """Phase 28: the four K2 instances (NB, joint; grad-only, value)
    against ``valgrad_ref`` at every B of VALGRAD_BS x D of VALGRAD_DS
    (D off and on the 64-column tile, ragged row chunks), with the
    compile-time widths (2, 1, 1) and a general instance (4, 2, 3), and
    the wide widths WIDE_WIDTHS (T = 17 to 128) at WIDE_BS x WIDE_DS:
    integer counts stored as int8, int16 and float32 (the three bitwise
    equal), non-integer float32 counts and, at the wide widths, counts
    <= 7.  Each call bitwise repeatable, the
    value-bearing gradients equal to the grad-only ones bitwise, every
    gradient within TRAIN_TOL, the value held to the float64 sum as phase
    22 holds it; each case launches the instance its plan names."""
    from mmvae_tpu_torch.ops import nb_step as ns

    g = torch.Generator(device=DEV).manual_seed(SEED + 28)
    worst = {name: 0.0 for name, _, _ in VALGRAD_VARIANTS}
    worst_q, n_cases, t0 = 0.0, 0, time.time()
    log(f"[phase 28] K2, K2p, K2v, K2pv vs plain at B {VALGRAD_BS} x D "
        f"{VALGRAD_DS} x widths {VALGRAD_WIDTHS} and B {WIDE_BS} x D "
        f"{WIDE_DS} x widths {WIDE_WIDTHS}, counts int8 == int16 == "
        f"float32, non-integer float32 (and int8 <= 7 at the wide widths); "
        f"gradients {TRAIN_TOL}; value |kernel - f64| <= 2 |plain - f64| + "
        f"2.01e-5 * S")
    for B, D, widths in width_cases(VALGRAD_BS, VALGRAD_DS, VALGRAD_WIDTHS):
        R, C, Rn = widths
        x8, zc, zn, depth, Wj, _ = joint_step_inputs(
            g, B, D, torch.int8, "integer", widths)
        Wn = Wj[:-1].contiguous()
        counts = count_kinds(g, x8, B, D, widths in WIDE_WIDTHS)
        for name, joint, value in VALGRAD_VARIANTS:
            W = Wj if joint else Wn
            plan = ns.valgrad_plan(B, D, R, C, Rn, joint, value)
            if plan.instance != ("fixed" if widths == (2, 1, 1)
                                 else "general"):
                raise AssertionError(f"plan {plan} for {widths}")
            lr = ns.lse_ref(zc, W, R, C)
            ref_bits = None
            for kind, x in counts.items():
                kern = lambda: ns.valgrad(  # noqa: E731
                    x, zc, zn, depth, lr, W, R, C, Rn, joint, value)
                got, again = kern(), kern()
                torch.cuda.synchronize()
                if not all(torch.equal(a, b)
                           for a, b in zip(got, again)):
                    raise AssertionError(f"{name} not bitwise "
                                         f"repeatable")
                if value:
                    grad = ns.valgrad(x, zc, zn, depth, lr, W, R, C,
                                      Rn, joint)
                    if not all(torch.equal(a, b)
                               for a, b in zip(got[:4], grad)):
                        raise AssertionError(
                            f"{name}'s gradients differ from the "
                            f"grad-only instance's at {(B, D)}")
                if kind in ("int16", "float32"):
                    if not all(torch.equal(a, b)
                               for a, b in zip(got, ref_bits)):
                        raise AssertionError(
                            f"{name}: {kind} storage != int8 at "
                            f"{(B, D, widths)}")
                    continue
                ref_bits = got
                want = ns.valgrad_ref(x, zc, zn, depth, lr, W, R, C,
                                      Rn, joint, value)
                e, q = 0.0, 0.0
                for gt, wt, S in zip(got, want, valgrad_bounds(
                        x, zc, zn, depth, lr, W, R, C, Rn, joint)):
                    ei, qi = ratio(gt, wt, S)
                    e, q = max(e, ei), max(q, qi)
                if value:
                    terms = value_terms(x, zc, zn, depth, lr, W, R,
                                        C, Rn, joint)
                    ref = terms.sum()
                    e_k = (got[4].double() - ref).abs().item()
                    e_p = (want[4].double() - ref).abs().item()
                    q = max(q, e_k / (2.0 * e_p + 2.01e-5
                                      * terms.abs().sum().item()))
                if not q <= 1.0:
                    raise AssertionError(
                        f"{name} disagrees with plain at B={B} "
                        f"D={D} widths {widths} {kind}: err/tol "
                        f"{q:.3g}")
                worst[name] = max(worst[name], e)
                worst_q = max(worst_q, q)
                n_cases += 1
    log(f"[phase 28] [{card}] {n_cases} cases held to plain "
        f"({time.time() - t0:.1f}s), worst err/tol {worst_q:.3g}; max |err| "
        + ", ".join(f"{k} {v:.3g}" for k, v in worst.items())
        + "; every call bitwise repeatable, int8 == int16 == float32 "
        "storage, value-bearing gradients == grad-only bitwise")
    return worst


BWD_MS = (1, 37, DP_M, 100, 1600)
BWD_DS = VALGRAD_DS
# K5's compile-time widths (the trainers', first: phase 29 times them),
# the generic NB step's encoder (2 + 0), a general one at the launch's 16
# rows with no raw side, a general one with both
BWD_WIDTHS = ((2, 2), (5, 3), (12, 3), (2, 0), (16, 0), (7, 9))
LSE_WIDTHS = ((2, 1), (4, 2), (15, 0))  # K1's compile-time (R, C), general
# K1 at the wide widths' (R, C) (WIDE_BS x WIDE_DS) and at (13, 3), a
# covariate file of 3 columns at latent 13: one slice and a partial one
LSE_WIDE = tuple(w for w in dict.fromkeys((R, C) for R, C, _ in WIDE_WIDTHS)
                 if w not in LSE_WIDTHS) + ((13, 3),)


def stage_ms(per: dict, stage1: str) -> tuple[float, float]:
    """(stage 1, stage 2) device ms of one call from ``device_profile``'s
    kernel table: the kernels named ``stage1``, then the rest."""
    s1 = sum(v for k, v in per.items() if stage1 in k)
    return s1, sum(per.values()) - s1


def plan_line(plan) -> str:
    """A launch plan's instance and grid, for a log line."""
    return f"{plan.instance} instance, grid {plan.grid}"


def phase_bwd_lse_cases(card):
    """Phase 29: K5 (every ``count_encode_bwd.cu`` instance) at M of
    BWD_MS x D of BWD_DS x widths BWD_WIDTHS, and K1 (both ``nb_lse.cu``
    instances) at B of BWD_MS x the same D x LSE_WIDTHS (and LSE_WIDE at
    WIDE_BS x WIDE_DS, the general instance's slices), against their
    plain versions within TRAIN_TOL (phase 6's bounds): K5 with integer
    counts stored as int8, int16 and float32 (the three bitwise equal)
    and non-integer float32 counts; every call bitwise repeatable; each
    case launches the instance its plan names.  Then the main path's
    shapes (M = 100, D = 20,000, int8): K5 at 2 + 2, 5 + 3 and 12 + 3
    and K1 at (2, 1), stage 1 and stage 2 apart, beside the plain
    version and, for K5, the library's two products on operands widened
    beforehand."""
    from mmvae_tpu_torch.ops import enc_kernel as enc
    from mmvae_tpu_torch.ops import nb_step as ns

    g = torch.Generator(device=DEV).manual_seed(SEED + 29)
    worst = {"count_encode_bwd": 0.0, "nb_lse": 0.0}
    worst_q, n_cases, t0 = 0.0, 0, time.time()
    log(f"[phase 29] K5 vs plain at M {BWD_MS} x D {BWD_DS} x (r1, r2) "
        f"{BWD_WIDTHS}, counts int8 == int16 == float32 and non-integer "
        f"float32; K1 vs plain at B {BWD_MS} x the same D x (R, C) "
        f"{LSE_WIDTHS} and B {WIDE_BS} x D {WIDE_DS} x {LSE_WIDE}; "
        f"{TRAIN_TOL}")
    for M in BWD_MS:
        for D in BWD_DS:
            x8 = make_counts(g, M, D, torch.int8)
            counts = {"int8": x8, "int16": x8.to(torch.int16),
                      "float32": x8.float(),
                      "non-integer": make_counts(g, M, D, torch.float32)}
            for r1, r2 in BWD_WIDTHS:
                plan = enc.bwd_plan(M, D, r1, r2)
                if plan.instance != ("fixed" if (r1, r2) in enc.BWD_FIXED
                                     else "general"):
                    raise AssertionError(f"plan {plan} for {(r1, r2)}")
                g1 = torch.randn((M, r1), generator=g, device=DEV)
                g2 = (torch.randn((M, r2), generator=g, device=DEV)
                      if r2 else None)
                ref_bits = None
                for kind, x in counts.items():
                    got = enc.count_encode_bwd(x, g1, g2)
                    again = enc.count_encode_bwd(x, g1, g2)
                    torch.cuda.synchronize()
                    if not all(a is b or torch.equal(a, b)
                               for a, b in zip(got, again)):
                        raise AssertionError("count_encode_bwd not bitwise "
                                             "repeatable")
                    if kind in ("int16", "float32"):
                        if not all(a is b or torch.equal(a, b)
                                   for a, b in zip(got, ref_bits)):
                            raise AssertionError(
                                f"count_encode_bwd: {kind} storage != int8 "
                                f"at {(M, D, r1, r2)}")
                        continue
                    ref_bits = got
                    want = enc.count_encode_bwd_ref(x, g1, g2)
                    xd = x.double()
                    S = (g1.double().abs().T @ xd.log1p(),
                         None if g2 is None else g2.double().abs().T
                         @ xd.abs())
                    for gt, wt, b in zip(got, want, S):
                        if gt is None:
                            continue
                        e, q = ratio(gt, wt, b)
                        worst["count_encode_bwd"] = max(
                            worst["count_encode_bwd"], e)
                        worst_q = max(worst_q, q)
                        if not q <= 1.0:
                            raise AssertionError(
                                f"count_encode_bwd disagrees with plain at "
                                f"M={M} D={D} {(r1, r2)} {kind}: err/tol "
                                f"{q:.3g}")
                    n_cases += 1
            wide = LSE_WIDE if (M in WIDE_BS and D in WIDE_DS) else ()
            for R, C in LSE_WIDTHS + wide:
                plan = ns.lse_plan(M, D, R, C)
                if plan.instance != ("fixed" if (R, C) == ns.LSE_FIXED
                                     else "general"):
                    raise AssertionError(f"plan {plan} for {(R, C)}")
                zc = torch.randn((M, R + C), generator=g, device=DEV)
                W = torch.randn((R + C + 1, D), generator=g,
                                device=DEV) * 0.3
                got, again = ns.lse(zc, W, R, C), ns.lse(zc, W, R, C)
                torch.cuda.synchronize()
                if not torch.equal(got, again):
                    raise AssertionError("nb_lse not bitwise repeatable")
                want = ns.lse_ref(zc, W, R, C)
                e, q = ratio(got, want, 1.0 + want.double().abs())
                worst["nb_lse"] = max(worst["nb_lse"], e)
                worst_q = max(worst_q, q)
                if not q <= 1.0:
                    raise AssertionError(f"nb_lse disagrees with plain at "
                                         f"B={M} D={D} {(R, C)}: err/tol "
                                         f"{q:.3g}")
                n_cases += 1
    log(f"[phase 29] [{card}] {n_cases} cases held to plain "
        f"({time.time() - t0:.1f}s), worst err/tol {worst_q:.3g}; max |err| "
        + ", ".join(f"{k} {v:.3g}" for k, v in worst.items())
        + "; every call bitwise repeatable, K5's int8 == int16 == float32 "
        "storage")

    # the main path's shapes, stages apart
    times = {}
    x = make_counts(g, B_TRAIN, D_GENES, torch.int8)
    xf = x.float()
    L = torch.log1p(xf)
    for r1, r2 in BWD_WIDTHS[:3]:
        g1 = torch.randn((B_TRAIN, r1), generator=g, device=DEV)
        g2 = torch.randn((B_TRAIN, r2), generator=g, device=DEV)
        ms, per = device_profile(lambda: enc.count_encode_bwd(x, g1, g2),
                                 20)
        s1, s2 = stage_ms(per, "count_encode_bwd_tiles")
        p_ms, _ = device_profile(lambda: enc.count_encode_bwd_ref(x, g1, g2),
                                 20)
        lib_ms, _ = device_profile(lambda: (g1.T @ L, g2.T @ xf), 20)
        times[(r1, r2)] = dict(ms=ms, plain_ms=p_ms, library_ms=lib_ms)
        plan = enc.bwd_plan(B_TRAIN, D_GENES, r1, r2)
        log(f"[phase 29] [{card}] count_encode_bwd M={B_TRAIN} D={D_GENES} "
            f"int8 {r1} + {r2} ({plan_line(plan)}): "
            f"kernel {ms:.4f} ms = stage 1 {s1:.4f} + stage 2 {s2:.4f}; "
            f"plain {p_ms:.4f} ms; library (two torch.mm on widened "
            f"operands) {lib_ms:.4f} ms")
    zc = torch.randn((B_TRAIN, 3), generator=g, device=DEV)
    W = torch.randn((4, D_GENES), generator=g, device=DEV) * 0.3
    ms, per = device_profile(lambda: ns.lse(zc, W, 2, 1), 20)
    s1, s2 = stage_ms(per, "lse_tiles")
    p_ms, _ = device_profile(lambda: ns.lse_ref(zc, W, 2, 1), 20)
    log(f"[phase 29] [{card}] nb_lse B={B_TRAIN} D={D_GENES} (2, 1) "
        f"({plan_line(ns.lse_plan(B_TRAIN, D_GENES, 2, 1))}): kernel "
        f"{ms:.4f} ms = "
        f"stage 1 {s1:.4f} + stage 2 {s2:.4f}; plain {p_ms:.4f} ms")
    return worst, times


def value_bound(x, zc, zn, depth, l, W, R, C, Rn, joint, include_const):
    """S of K6's NLL: the float64 sum over elements of the magnitudes of
    each term's pieces before they cancel, lgamma(nu), lgamma(nu + x),
    x log(mu + nu), x log mu, nu log(mu + nu), nu log nu (and
    lgamma(x + 1)), as grad_magnitudes bounds K2's sums: where nu sits at
    its NU_HI clamp, lgamma(nu) - lgamma(nu + x) and nu (log(mu + nu) -
    log nu) cancel to a small term, and float32 rounding lands on the
    pieces (~8e4 at nu = 1e4), which a sum of the cancelled terms alone
    leaves out at one row."""
    d = lambda t: t.double()  # noqa: E731
    zc, zn, depth, l, W, x = map(d, (zc, zn, depth, l, W, x))
    RC, base = R + C, R + C + 1
    ls = zc @ W[:RC] + W[RC] - l
    if joint:
        ls = ls + W[base + Rn + 1]
    mu = torch.exp(ls) * depth + 1e-4
    npre = zn @ W[base:base + Rn] + W[base + Rn]
    if joint:
        nu = torch.exp(npre).clamp(max=1e4) + 1e-4
    else:
        nu = torch.nn.functional.softplus(npre).clamp(1e-4, 1e4) + 1e-4
    lmn = torch.log(mu + nu).abs()
    S = (torch.lgamma(nu).abs() + torch.lgamma(nu + x).abs()
         + x.abs() * (lmn + torch.log(mu).abs())
         + nu * (lmn + torch.log(nu).abs()))
    if include_const:
        S = S + torch.lgamma(x + 1.0).abs()
    return S.sum()


def finish_bounds(zc, l, rs, W, R, C):
    """S of K3's outputs (fout, u2): the same sums over the float64
    magnitudes of their terms (phase 6's bounds)."""
    from mmvae_tpu_torch.ops import nb_step as ns

    p = torch.exp(ns._h(zc.double(), W.double(), R + C) - l.double())
    prs = p * rs.double().abs()
    return (torch.cat([zc.double().abs().T @ prs, prs.sum(0, True)]),
            p @ W.double().abs()[:R].T)


def phase_value_finish_cases(card):
    """Phase 30: K6 (``value``, with and without lgamma(x + 1)), K6p
    (``value(joint=True)``) and K3 (``finish``) against their plain
    versions within TRAIN_TOL (K3 with phase 6's bounds, K6 with
    ``value_bound``, which also holds the one-row cases) at every B of
    VALGRAD_BS
    x D of VALGRAD_DS x VALGRAD_WIDTHS and at the wide widths on WIDE_BS x
    WIDE_DS, the counts of phase 28 (integer counts as int8, int16 and
    float32, bitwise equal; non-integer float32; counts <= 7 at the wide
    widths): every call bitwise repeatable, each case on the instance its
    plan names; K2, K6 and K3 at the most stacked rows their plans take
    (``nb_step.MAX_STACKED_ROWS``, the card's shared memory a block).
    Then the main path's shapes (B = 100, D = 20,000, int8
    integer counts): K6, K6p at (2, 1, 1) and K3 at (2, 1), stage 1 and
    stage 2 apart, beside the plain versions."""
    from mmvae_tpu_torch.ops import nb_step as ns

    g = torch.Generator(device=DEV).manual_seed(SEED + 30)
    worst = {"nb_value": 0.0, "nb_value[pb,nu_exp]": 0.0, "nb_finish": 0.0}
    worst_q, n_cases, t0 = 0.0, 0, time.time()
    log(f"[phase 30] K6, K6p, K3 vs plain at B {VALGRAD_BS} x D "
        f"{VALGRAD_DS} x widths {VALGRAD_WIDTHS} and B {WIDE_BS} x D "
        f"{WIDE_DS} x widths {WIDE_WIDTHS}, counts int8 == int16 == "
        f"float32, non-integer float32 (and int8 <= 7 at the wide widths); "
        f"{TRAIN_TOL}")

    def held(name, got, want, bounds, what):
        nonlocal worst_q
        e, q = 0.0, 0.0
        for gt, wt, S in zip(got, want, bounds):
            ei, qi = ratio(gt, wt, S)
            e, q = max(e, ei), max(q, qi)
        if not q <= 1.0:
            raise AssertionError(f"{name} disagrees with plain at {what}: "
                                 f"err/tol {q:.3g}")
        worst[name] = max(worst[name], e)
        worst_q = max(worst_q, q)

    for B, D, widths in width_cases(VALGRAD_BS, VALGRAD_DS, VALGRAD_WIDTHS):
        R, C, Rn = widths
        x8, zc, zn, depth, Wj, _ = joint_step_inputs(g, B, D, torch.int8,
                                                     "integer", widths)
        Wn = Wj[:-1].contiguous()
        counts = count_kinds(g, x8, B, D, widths in WIDE_WIDTHS)
        for joint, W in ((False, Wn), (True, Wj)):
            name = "nb_value[pb,nu_exp]" if joint else "nb_value"
            plan = ns.value_plan(B, D, R, C, Rn, joint)
            if plan.instance != ("fixed" if widths == (2, 1, 1)
                                 else "general"):
                raise AssertionError(f"plan {plan} for {widths}")
            lr = ns.lse_ref(zc, W, R, C)
            for wc in (True, False):
                ref_bits = None
                for kind, x in counts.items():
                    got = ns.value(x, zc, zn, depth, lr, W, R, C, Rn, wc,
                                   joint)
                    again = ns.value(x, zc, zn, depth, lr, W, R, C, Rn, wc,
                                     joint)
                    torch.cuda.synchronize()
                    if not torch.equal(got, again):
                        raise AssertionError(f"{name} not bitwise "
                                             f"repeatable")
                    if kind in ("int16", "float32"):
                        if not torch.equal(got, ref_bits):
                            raise AssertionError(
                                f"{name}: {kind} storage != int8 at "
                                f"{(B, D, widths)}")
                        continue
                    ref_bits = got
                    want = ns.value_ref(x, zc, zn, depth, lr, W, R, C, Rn,
                                        wc, joint)
                    S = value_bound(x, zc, zn, depth, lr, W, R, C, Rn, joint,
                                    wc)
                    held(name, (got,), (want,), (S,),
                         f"B={B} D={D} widths {widths} {kind} const {wc}")
                    n_cases += 1
        plan = ns.finish_plan(B, D, R, C)
        if plan.instance != ("fixed" if (R, C) == (2, 1) else "general"):
            raise AssertionError(f"plan {plan} for {(R, C)}")
        lr = ns.lse_ref(zc, Wn, R, C)
        rs = ns.valgrad_ref(x8, zc, zn, depth, lr, Wn, R, C, Rn)[1]
        rs = rs.contiguous()
        got = ns.finish(zc, lr, rs, Wn, R, C)
        again = ns.finish(zc, lr, rs, Wn, R, C)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError("nb_finish not bitwise repeatable")
        held("nb_finish", got, ns.finish_ref(zc, lr, rs, Wn, R, C),
             finish_bounds(zc, lr, rs, Wn, R, C),
             f"B={B} D={D} (R, C) = {(R, C)}")
        n_cases += 1
    # the card's limit: each general instance at the most stacked rows
    # its plan takes (the shared memory of one block)
    B, D = 37, 257
    lim = ns.MAX_STACKED_ROWS
    for name, (R, C, Rn) in (("nb_valgrad", (2, lim["valgrad"] - 5, 1)),
                             ("nb_value", (2, lim["value"] - 5, 1)),
                             ("nb_finish", (2, lim["finish"] - 3, 1))):
        x, zc, zn, depth, Wj, _ = joint_step_inputs(g, B, D, torch.int8,
                                                    "integer", (R, C, Rn))
        W = Wj[:-1].contiguous()
        lr = ns.lse_ref(zc, W, R, C)
        what = f"the limit, B={B} D={D} {(R, C, Rn)}"
        if name == "nb_valgrad":
            q = max(ratio(gt, wt, S)[1] for gt, wt, S in zip(
                ns.valgrad(x, zc, zn, depth, lr, W, R, C, Rn),
                ns.valgrad_ref(x, zc, zn, depth, lr, W, R, C, Rn),
                valgrad_bounds(x, zc, zn, depth, lr, W, R, C, Rn)))
            if not q <= 1.0:
                raise AssertionError(f"nb_valgrad disagrees with plain at "
                                     f"{what}: err/tol {q:.3g}")
            worst_q = max(worst_q, q)
        elif name == "nb_value":
            held(name, (ns.value(x, zc, zn, depth, lr, W, R, C, Rn),),
                 (ns.value_ref(x, zc, zn, depth, lr, W, R, C, Rn, True),),
                 (value_bound(x, zc, zn, depth, lr, W, R, C, Rn, False,
                              True),), what)
        else:
            rs = ns.valgrad_ref(x, zc, zn, depth, lr, W, R, C, Rn)[1]
            rs = rs.contiguous()
            held(name, ns.finish(zc, lr, rs, W, R, C),
                 ns.finish_ref(zc, lr, rs, W, R, C),
                 finish_bounds(zc, lr, rs, W, R, C), what)
        n_cases += 1
    log(f"[phase 30] [{card}] {n_cases} cases held to plain "
        f"({time.time() - t0:.1f}s), worst err/tol {worst_q:.3g}; max |err| "
        + ", ".join(f"{k} {v:.3g}" for k, v in worst.items())
        + "; every call bitwise repeatable, K6's and K6p's int8 == int16 == "
        f"float32 storage; K2, K6 and K3 at the card's limit {lim} stacked "
        "rows")

    # the main path's shapes, stages apart
    times = {}
    x, zc, zn, depth, Wj, (R, C, Rn) = joint_step_inputs(
        g, B_TRAIN, D_GENES, torch.int8, "integer")
    Wn = Wj[:-1].contiguous()
    lr = ns.lse(zc, Wn, R, C)
    rs = ns.valgrad(x, zc, zn, depth, lr, Wn, R, C, Rn)[1].contiguous()
    for name, kern, plain, stage1, plan in (
            ("nb_value", lambda: ns.value(x, zc, zn, depth, lr, Wn, R, C, Rn),
             lambda: ns.value_ref(x, zc, zn, depth, lr, Wn, R, C, Rn, True),
             "value_tiles", ns.value_plan(B_TRAIN, D_GENES, R, C, Rn)),
            ("nb_value[pb,nu_exp]",
             lambda: ns.value(x, zc, zn, depth, lr, Wj, R, C, Rn, True, True),
             lambda: ns.value_ref(x, zc, zn, depth, lr, Wj, R, C, Rn, True,
                                  True),
             "value_tiles", ns.value_plan(B_TRAIN, D_GENES, R, C, Rn, True)),
            ("nb_finish", lambda: ns.finish(zc, lr, rs, Wn, R, C),
             lambda: ns.finish_ref(zc, lr, rs, Wn, R, C), "finish_tiles",
             ns.finish_plan(B_TRAIN, D_GENES, R, C))):
        ms, per = device_profile(kern, 20)
        s1, s2 = stage_ms(per, stage1)
        p_ms, _ = device_profile(plain, 20)
        times[name] = (ms, p_ms)
        log(f"[phase 30] [{card}] {name} B={B_TRAIN} D={D_GENES} int8 "
            f"({plan_line(plan)}): kernel {ms:.4f} ms = stage 1 {s1:.4f} + "
            f"stage 2 {s2:.4f}; plain {p_ms:.4f} ms")
    return worst, times


def phase_wide_cli(card, tmp, mtx):
    """Phase 31: ``nb_vae --mean_latent 13`` with the one all-ones
    covariate column (13 + 1 + 1 + 2 = 17 stacked rows, past the 16 the
    step kernels once took) on phase 4's matrix for one epoch on the
    card, its launch counters set to 0 just before and read just after:
    every kernel of the NB path launched, the step kernels' plans on
    their general instances, the score finite."""
    from mmvae_tpu_torch.cli import nb_vae
    from mmvae_tpu_torch.ops import nb_step as ns

    tag = "[phase 31]"
    out = os.path.join(tmp, "wide")
    R, C, Rn = 13, 1, 1
    plans = {"nb_lse": ns.lse_plan(B_TRAIN, D_GENES, R, C),
             "nb_value": ns.value_plan(B_TRAIN, D_GENES, R, C, Rn),
             "nb_valgrad": ns.valgrad_plan(B_TRAIN, D_GENES, R, C, Rn),
             "nb_finish": ns.finish_plan(B_TRAIN, D_GENES, R, C)}
    if any(p.instance != "general" for p in plans.values()):
        raise AssertionError(f"plans at {(R, C, Rn)}: {plans}")
    reset_launches()
    t0 = time.time()
    err = run_cli(nb_vae, ["--mtx", mtx, "--batch_size", str(B_TRAIN),
                           "--device", DEV, "--mean_latent", str(R),
                           "--max_epoch", "1", "--out", out])
    wall = time.time() - t0
    launches = read_launches()
    if min(launches[k] for k in NB_PATH) < 1:
        raise AssertionError(f"nb_vae --mean_latent {R} skipped a kernel: "
                             f"{launches}")
    scores = np.loadtxt(out + ".scores.gz", ndmin=1)
    if scores.shape != (1,) or not np.isfinite(scores).all():
        raise AssertionError(f"nb_vae --mean_latent {R}: scores {scores}")
    rate = next((ln.split("] ", 1)[-1] for ln in err.splitlines()
                 if "cells/sec" in ln), "")
    log(f"{tag} [{card}] nb_vae --mean_latent {R} (R, C, Rn) = {(R, C, Rn)},"
        f" {N_CLI} x {D_GENES}, 1 epoch: {step_line(err)}; score "
        f"{scores.tolist()}; kernel launches "
        f"{ {k: launches[k] for k in NB_PATH} }, step kernels on "
        + ", ".join(f"{k} {plan_line(p)}" for k, p in plans.items())
        + f"; {rate}; CLI wall {wall:.2f}s")
    return launches


# label -> (model, architecture, step options, the library trainer)
VMFNB_GENERIC_ROUTES = {
    "joint --mean_encoding 16, v2 step kernels": (
        "joint", dict(mean_encoding=(16,)), {}, False),
    "joint --vmf_decoding 16, v2 step kernels": (
        "joint", dict(vmf_decoding=(16,)), {}, False),
    "joint --mean_decoding 16, forward + composite loss": (
        "joint", dict(mean_decoding=(16,)), {}, False),
    "joint --no_fused_step, forward + composite loss": (
        "joint", {}, dict(fused_step=False), False),
    "joint library trainer (fused_step_boot, K2pv)": ("joint", {}, {}, True),
    "mixture --mean_encoding 16, v2 step kernels": (
        "mixture", dict(mean_encoding=(16,)), {}, False),
    "mixture --no_fused_step, forward + composite loss": (
        "mixture", {}, dict(fused_step=False), False),
    "mixture library trainer (fused_step_boot, K2pv)": (
        "mixture", {}, {}, True),
}


def vmfnb_model(kind: str, **arch):
    """The joint model or the mixture (with :func:`marker_label`) at
    D = 20,000 and the given architecture."""
    if kind == "mixture":
        from mmvae_tpu_torch.models.vmfnb_mixture import VMFNBMixtureVAE

        return VMFNBMixtureVAE(label=marker_label(), **arch)
    from mmvae_tpu_torch.models.vmfnb import VMFNBVAE

    return VMFNBVAE(data_dim=D_GENES, **arch)


def vmfnb_trainer(model, topt, plain=False, library=False):
    """The step ``vmfnb_vae`` builds for ``model`` and ``topt``
    (``make_step``), or with ``library`` the JAX README's library trainer
    on either model: the generic ``Trainer`` with ``fused_step_report``
    and the value-bearing ``fused_step_boot`` (K2pv)."""
    import dataclasses

    from mmvae_tpu_torch.cli.vmfnb_vae import make_step
    from mmvae_tpu_torch.train.loop import Trainer

    if not library:
        return make_step(model, topt, plain=plain)[0]
    # forward, the composite loss and the draws of the generic step
    step = make_step(model, dataclasses.replace(topt, fused=False),
                     plain=plain)[0]
    return Trainer(
        step.forward, step.loss_fn, topt, eps_widths=step.eps_widths,
        report_loss_override=lambda p, x, c, e, b: model.fused_step_report(
            p, x, c, e, b, plain=plain),
        boot_loss_override=lambda p, x, c, e, b: model.fused_step_boot(
            p, x, c, e, b, need_value=True, plain=plain))


def phase_vmfnb_generic_step(card):
    """Phase 23: one generic batch step per route of the joint model and
    the mixture, kernel route against plain route
    (:func:`check_generic_route`, the ``ln_kappa`` leaves held to the
    float64 step)."""
    from mmvae_tpu_torch.train.config import TrainingOptions

    g = torch.Generator(device=DEV).manual_seed(SEED + 23)
    x = make_counts(g, B_TRAIN, D_GENES, torch.int8)
    c = torch.ones((B_TRAIN, 1), device=DEV)
    for label, (kind, arch, flags, library) in VMFNB_GENERIC_ROUTES.items():
        model = vmfnb_model(kind, **arch)
        check_generic_route(
            card, "[phase 23]", label,
            lambda plain: vmfnb_trainer(model, TrainingOptions(**flags),
                                        plain, library),
            random_params(model, DEV), x, c, value_boot=library, joint=True)


def phase_vmfnb_generic_cli(card, tmp, mtx):
    """Phase 24: ``vmfnb_vae`` on the generic step end to end, every
    launch counter reset just before each run and read just after: the
    joint model with ``--mean_encoding 16 --vmf_decoding 16`` and the
    mixture with ``--mean_encoding 16`` (the v2 step kernels' grad-only
    joint variant) for 2 epochs with recording and a checkpoint, then
    ``--resume``; ``--mean_encoding 16 --mean_decoding 16``,
    ``--no_fused_step`` and ``--no_fused`` (``forward`` + the composite
    loss: only the count encoder's kernels) for one epoch each; the JAX
    README's library trainer of each model (the main path of K2pv) for
    one epoch; ``encode --model vmfnb|mixture`` of hidden-layer
    checkpoints against the plain unfolded encoders.  Width 16 is a test
    width: the reference publishes no hidden-layer default."""
    from mmvae_tpu_torch.cli import vmfnb_vae
    from mmvae_tpu_torch.train.config import TrainingOptions

    tag = "[phase 24]"
    j_launches, _ = phase_train_cli(
        card, tmp, mtx, "joint", dict(mean_encoding=(16,),
                                      vmf_decoding=(16,)),
        tag, "v2 step kernels")
    m_launches, mck = phase_train_cli(
        card, tmp, mtx, "mixture", dict(mean_encoding=(16,)), tag,
        "v2 step kernels")
    for n in (j_launches, m_launches):
        if n["nb_valgrad[pb,nu_exp,value]"]:
            raise AssertionError("the grad-only route launched K2pv")
    args = ["--mtx", mtx, "--batch_size", str(B_TRAIN), "--device", DEV,
            "--max_epoch", "1"]
    hidden = dict(mean_encoding=(16,), mean_decoding=(16,))
    hck = os.path.join(tmp, "jdec_ckpt")
    step_kernels = [k for k in JOINT_PATH if k.startswith("nb_")]
    for flags in (arch_flags(hidden) + ["--checkpoint_dir", hck],
                  ["--no_fused_step"], ["--no_fused"]):
        reset_launches()
        err = run_cli(vmfnb_vae, args + flags + [
            "--out", os.path.join(tmp, "jgen")])
        n = read_launches()
        route = step_line(err)
        label = " ".join(flags[:4])
        if ("forward + composite loss" not in route
                or min(n["count_encode[stats]"], n["count_encode_bwd"]) < 1
                or any(n[k] for k in step_kernels)):
            raise AssertionError(f"vmfnb_vae {label}: route {route!r}, "
                                 f"launches {n}")
        log(f"{tag} [{card}] vmfnb_vae {label}, 1 epoch: step {route!r}; "
            f"launches { {k: n[k] for k in JOINT_PATH[:2]} }; "
            + [ln.split("] ", 1)[-1] for ln in err.splitlines()
               if "cells/sec" in ln][-1])
    lib = {}
    topt = TrainingOptions(max_epoch=1)
    for kind, path in (("joint", JOINT_VALUE_PATH),
                       ("mixture", MIXTURE_VALUE_PATH)):
        model = vmfnb_model(kind)
        lib[kind] = library_epoch(
            card, tag, f"{kind} library trainer (fused_step_report / "
            f"fused_step_boot, K2pv)", tmp, mtx, model,
            vmfnb_trainer(model, topt, library=True), topt, path)
        if lib[kind]["nb_valgrad[pb,nu_exp]"]:
            raise AssertionError("the library trainer launched K2p")
    phase_joint_encode(card, tmp, mtx, hck, hidden, tag)
    phase_mixture_encode(card, tmp, mtx, mck, dict(mean_encoding=(16,)),
                         tag)
    return j_launches, m_launches, lib


# ----------------------------------------------------------------------
# the roofline probe and the tooling (26-27)
# ----------------------------------------------------------------------

P1_TOL = ("|kernel - plain| <= 1e-5 * |plain| elementwise (every op is a "
          "contraction, so FFMA's one rounding against the plain version's "
          "two stays a few ulp)")
P1_CASES = [(op, chains, nrep) for op in ("fma", "exp", "log", "div",
                                          "select")
            for chains in (1, 4) for nrep in (8, 40)]


def phase_roofline(card):
    """Phase 26: P1 (``csrc/roofline_probe.cu``) against its plain
    version in all five op classes x ILP {1, 4} x nrep {8, 40} at K2's
    shape, bitwise repeatable; device times of the fma class at ILP 4,
    nrep 40; then the probe's ``main()`` (per-op costs, K2's op-mix
    bracket, K2 alone), its launches counted from 0."""
    from mmvae_tpu_torch.benchmarks import valgrad_roofline as vr

    tag = "[phase 26]"
    x = vr.probe_input(DEV)
    worst, worst_q = 0.0, 0.0
    for op, chains, nrep in P1_CASES:
        k = vr.elementwise(x, op, nrep, chains)
        k2 = vr.elementwise(x, op, nrep, chains)
        p = vr.elementwise_ref(x, op, nrep, chains)
        torch.cuda.synchronize()
        if not torch.equal(k, k2):
            raise AssertionError(f"P1 {op} x{chains} nrep {nrep}: two "
                                 f"launches differ")
        err = (k - p).abs()
        q = (err / (1e-5 * p.abs())).max().item()
        if not (torch.isfinite(k).all() and q <= 1.0):
            raise AssertionError(f"P1 {op} x{chains} nrep {nrep}: err/tol "
                                 f"{q:.3g} ({P1_TOL})")
        worst, worst_q = max(worst, err.max().item()), max(worst_q, q)
    k_ms, _ = device_profile(lambda: vr.elementwise(x, "fma", 40, 4), 20)
    p_ms, _ = device_profile(lambda: vr.elementwise_ref(x, "fma", 40, 4), 5)
    log(f"{tag} [{card}] P1 vs plain in {len(P1_CASES)} cases (5 op classes "
        f"x ILP 1, 4 x nrep 8, 40) at {tuple(x.shape)} float32: max |err| "
        f"{worst:.3g}, worst err/tol {worst_q:.3g} ({P1_TOL}); bitwise "
        f"repeatable; fma ILP 4 nrep 40: kernel {k_ms:.4f} ms, plain "
        f"{p_ms:.4f} ms device")
    reset_launches()
    res = vr.main()
    launches = read_launches()
    lo, hi = res["bracket_us"]
    k2 = res["k2"]
    rates = [v for r in res["rates_ps"].values() for v in r.values()]
    if not (np.isfinite(rates).all() and min(lo, hi) > 0
            and np.isfinite([lo, hi]).all()
            and k2["kernel_ms"] > 0 and launches["roofline_probe"] > 0
            and launches["nb_valgrad"] > 0):
        raise AssertionError(f"the probe's run: {res}, launches {launches}")
    log(f"{tag} [{card}] probe run: op mix at ILP 4 / ILP 1 against "
        f"stage 1 (valgrad_tiles) + stage 2 (valgrad_sum) alone, us: "
        + "; ".join(
            f"{k} {res['brackets_us'][k][0]:.2f} / {res['brackets_us'][k][1]:.2f}"
            f" vs {m['kernel_ms'] * 1e3:.2f} + {m['sum_ms'] * 1e3:.2f}"
            for k, m in res["k2_all"].items())
        + "; K6, K6p and K3 (phase 30 times them), K7, K7c and K8 (phase "
        "18): "
        + "; ".join(f"{k} {lo:.2f} / {hi:.2f}"
                    for k, (lo, hi) in res["brackets_us"].items()
                    if k not in res["k2_all"])
        + f"; launches { {k: n for k, n in launches.items() if n} }")
    return worst, (k_ms, p_ms), launches["roofline_probe"]


def phase_tooling(card, tmp, mtx):
    """Phase 27: ``trace_step joint`` at D = 20,000, B = 100, S = 8 (its
    table must name the port's kernels with device time) and ``trace_step
    vmf`` at the same size (PyTorch's kernels only), then ``nb_vae``
    on phase 4's matrix with ``MMVAE_TRACE_DIR`` set: a trace holding the
    ``ondevice_epoch`` annotation and the kernels, and ``.metrics.jsonl``
    rows with the JAX trainer's ``time_*`` keys (B = 1,000 keeps the
    trace to 8 batches: processing a trace costs about a second a
    batch)."""
    from mmvae_tpu_torch.benchmarks import trace_step
    from mmvae_tpu_torch.cli import nb_vae

    tag = "[phase 27]"
    buf = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(buf):
        rows = trace_step.main(["joint", str(D_GENES), "8", str(B_TRAIN),
                                "--out", os.path.join(tmp, "trace_joint")])
    wall = time.time() - t0
    by_kernel = {}
    for name, (us, _) in rows.items():
        k = trace_step.port_kernel(name)
        by_kernel[k] = by_kernel.get(k, 0.0) + us / 16
    need = ("count_encode", "count_encode_bwd", "nb_lse", "nb_value",
            "nb_valgrad", "nb_finish")
    if min(by_kernel.get(k, 0.0) for k in need) <= 0:
        raise AssertionError(f"trace_step's table lacks a port kernel: "
                             f"{by_kernel}")
    rate = next(ln for ln in buf.getvalue().splitlines() if "cells/sec" in ln)
    log(f"{tag} [{card}] trace_step joint {D_GENES} 8 {B_TRAIN} ({wall:.1f}s"
        f"): {rate}; device us a batch by kernel: "
        + ", ".join(f"{k} {v:.1f}" for k, v in
                    sorted(by_kernel.items(), key=lambda kv: -kv[1])))
    # the vMF-VAE's packed step: plain PyTorch, so every row of its table
    # is PyTorch's own
    buf = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(buf):
        rows = trace_step.main(["vmf", str(D_GENES), "8", str(B_TRAIN),
                                "--out", os.path.join(tmp, "trace_vmf")])
    wall = time.time() - t0
    kinds = {trace_step.port_kernel(name) for name in rows}
    us = sum(v for v, _ in rows.values()) / 16
    if kinds != {"torch"} or not us > 0:
        raise AssertionError(f"trace_step vmf's table: {kinds}, {us} us")
    rate = next(ln for ln in buf.getvalue().splitlines() if "cells/sec" in ln)
    top = sorted(rows.items(), key=lambda kv: -kv[1][0])[:3]
    log(f"{tag} [{card}] trace_step vmf {D_GENES} 8 {B_TRAIN} ({wall:.1f}s):"
        f" {rate}; device {us:.1f} us a batch in {len(rows)} PyTorch "
        f"kernels (no kernel of the port); top: " + "; ".join(
            f"{k[:50]} {v / 16:.1f} us" for k, (v, _) in top))

    out, tdir = os.path.join(tmp, "traced"), os.path.join(tmp, "cli_trace")
    os.environ["MMVAE_TRACE_DIR"] = tdir
    try:
        t0 = time.time()
        run_cli(nb_vae, ["--mtx", mtx, "--batch_size", "1000", "--device",
                         DEV, "--recording", "2", "--max_epoch", "2",
                         "--out", out])
        wall = time.time() - t0
    finally:
        del os.environ["MMVAE_TRACE_DIR"]
    traces = [os.path.join(tdir, f) for f in os.listdir(tdir)
              if f.endswith(".trace.json")]
    if len(traces) != 1:
        raise AssertionError(f"{tdir}: {traces}")
    with open(traces[0]) as f:
        text = f.read()
    stages = ("valgrad_tiles", "count_encode_bwd_tiles",
              "count_encode_bwd_sum", "lse_tiles", "lse_sum", "value_tiles",
              "value_sum", "finish_tiles", "finish_sum")
    if '"ondevice_epoch"' not in text or not all(k in text for k in stages):
        raise AssertionError(f"the trainer's trace lacks ondevice_epoch or "
                             f"one of the kernels {stages}")
    with open(out + ".metrics.jsonl") as f:
        recs = [json.loads(ln) for ln in f]
    base = {"epoch", "wall_time", "loss", "kl_weight", "cells_per_sec",
            "ondevice", "time_step"}
    want = [base, base | {"time_record_submit"}]
    if [set(r) for r in recs] != want:
        raise AssertionError(f"metrics rows {recs}")
    log(f"{tag} [{card}] nb_vae with MMVAE_TRACE_DIR ({wall:.1f}s, "
        f"{os.path.getsize(traces[0]) / 1e6:.1f} MB trace with "
        f"ondevice_epoch and the kernels): metrics rows "
        + " | ".join(", ".join(f"{k} {r[k]}" for k in sorted(r)
                               if k.startswith("time_")) for r in recs))


# every kernel instance of the port: (name, wrapper, launch counter,
# source, the TPU kernel it replaces)
KERNELS = [
    ("count_encode", "enc.count_encode", "launches", "count_encode.cu",
     "mmvae_tpu/ops/enc_kernel.py:183"),
    ("count_encode[stats]", "enc.count_encode", "stats_launches",
     "count_encode.cu", "mmvae_tpu/ops/enc_kernel.py:183"),
    ("count_encode[filt]", "enc.count_encode", "filt_launches",
     "count_encode.cu", "mmvae_tpu/ops/enc_kernel.py:183"),
    ("count_encode_bwd", "enc.count_encode_bwd", "launches",
     "count_encode_bwd.cu", "mmvae_tpu/ops/enc_kernel.py:216"),
    ("nb_lse", "ns.lse", "launches", "nb_lse.cu",
     "mmvae_tpu/ops/nb_step.py:320"),
    ("nb_value", "ns.value", "launches", "nb_value.cu",
     "mmvae_tpu/ops/nb_step.py:424"),
    ("nb_value[pb,nu_exp]", "ns.value", "joint_launches", "nb_value.cu",
     "mmvae_tpu/ops/nb_step.py:424"),
    ("nb_valgrad", "ns.valgrad", "launches", "nb_valgrad.cu",
     "mmvae_tpu/ops/nb_step.py:621"),
    ("nb_valgrad[pb,nu_exp]", "ns.valgrad", "joint_launches",
     "nb_valgrad.cu", "mmvae_tpu/ops/nb_step.py:621"),
    ("nb_finish", "ns.finish", "launches", "nb_finish.cu",
     "mmvae_tpu/ops/nb_step.py:704"),
    ("nb_elbo_fwd", "ne.elbo_fwd", "launches", "nb_elbo.cu",
     "mmvae_tpu/ops/nb_elbo.py:234"),
    ("nb_elbo_fwd[const]", "ne.elbo_fwd", "const_launches", "nb_elbo.cu",
     "mmvae_tpu/ops/nb_elbo.py:234"),
    ("nb_elbo_bwd", "ne.elbo_bwd", "launches", "nb_elbo.cu",
     "mmvae_tpu/ops/nb_elbo.py:301"),
    ("nb_valgrad[value]", "ns.valgrad", "value_launches", "nb_valgrad.cu",
     "mmvae_tpu/ops/nb_step.py:621"),
    ("nb_valgrad[pb,nu_exp,value]", "ns.valgrad", "joint_value_launches",
     "nb_valgrad.cu", "mmvae_tpu/ops/nb_step.py:621"),
    ("roofline_probe", "vr.elementwise", "launches", "roofline_probe.cu",
     "benchmarks/valgrad_roofline.py:69"),
]
NB_PATH = ["count_encode", "count_encode_bwd", "nb_lse", "nb_value",
           "nb_valgrad", "nb_finish"]
JOINT_PATH = ["count_encode[stats]", "count_encode_bwd", "nb_lse",
              "nb_value[pb,nu_exp]", "nb_valgrad[pb,nu_exp]", "nb_finish"]
MIXTURE_PATH = ["count_encode[filt]"] + JOINT_PATH[1:]
# the vMF-VAE is plain PyTorch, as the JAX package computes it in XLA: its
# path launches no kernel of the port
PATHS = {"nb": NB_PATH, "joint": JOINT_PATH, "mixture": MIXTURE_PATH,
         "vmf": []}
# the library trainer of the joint model and of the mixture (K2pv)
JOINT_VALUE_PATH = ["count_encode[stats]", "count_encode_bwd", "nb_lse",
                    "nb_value[pb,nu_exp]", "nb_valgrad[pb,nu_exp,value]",
                    "nb_finish"]
MIXTURE_VALUE_PATH = ["count_encode[filt]"] + JOINT_VALUE_PATH[1:]
# nb_vae on the generic step with the v1 ELBO kernels (a hidden decoder
# or --no_fused_step), and the README's library trainer (K2v)
GENERIC_PATH = ["count_encode", "count_encode_bwd", "nb_elbo_fwd",
                "nb_elbo_fwd[const]", "nb_elbo_bwd"]
README_PATH = ["count_encode", "count_encode_bwd", "nb_lse", "nb_value",
               "nb_valgrad[value]", "nb_finish"]


def _counters():
    from mmvae_tpu_torch.benchmarks import valgrad_roofline as vr
    from mmvae_tpu_torch.ops import enc_kernel as enc
    from mmvae_tpu_torch.ops import nb_elbo as ne
    from mmvae_tpu_torch.ops import nb_step as ns

    objs = {"enc": enc, "ne": ne, "ns": ns, "vr": vr}
    out = {}
    for name, wrapper, attr, _, _ in KERNELS:
        mod, fn = wrapper.split(".")
        out[name] = (getattr(objs[mod], fn), attr)
    return out


def reset_launches() -> None:
    """Set every kernel's launch counter to 0 (just before a main path)."""
    for w, attr in _counters().values():
        setattr(w, attr, 0)


def read_launches() -> dict:
    """Every kernel's launch count since :func:`reset_launches`."""
    return {name: getattr(w, attr) for name, (w, attr) in _counters().items()}


def arch_flags(arch: dict) -> list[str]:
    """The CLI flags of a hidden-layer architecture."""
    return [a for k, v in arch.items()
            for a in (f"--{k}", ",".join(map(str, v)))]


def step_line(err: str) -> str:
    """The route a trainer CLI logged in its one ``Step:`` line."""
    steps = [ln.split("Step: ", 1)[1] for ln in err.splitlines()
             if "Step: " in ln]
    if len(steps) != 1:
        raise AssertionError(f"expected one Step line, got {steps}")
    return steps[0]


def phase_train_cli(card, tmp, mtx, kind="nb", arch=None, tag=None,
                    route=None):
    """Phase 8 (``nb_vae``) / 12 (``vmfnb_vae``) / 16 (``vmfnb_vae
    --annot --row``) / 33 (``vmf_vae``): the trainer CLI on the synthetic
    matrix, 2 epochs with recording and a checkpoint, then ``--resume``
    for epoch 3; returns the first run's launches and the checkpoint.
    Every kernel of the model's path is launched (the vMF-VAE's path
    launches none).  ``arch`` (the vMF+NB models' hidden layers, phase
    24) adds its flags and ``route`` is then the step the run must log."""
    from mmvae_tpu_torch.cli import nb_vae, vmf_vae, vmfnb_vae
    from mmvae_tpu_torch.train.recorder import flatten_params, latent_names

    arch = arch or {}
    tag = tag or f"[phase {PHASE[kind]['cli']}]"
    cli = {"nb": nb_vae, "vmf": vmf_vae}.get(kind, vmfnb_vae)
    path = PATHS[kind]
    name = " ".join([{"nb": "nb_vae", "vmf": "vmf_vae", "joint": "vmfnb_vae",
                      "mixture": "vmfnb_vae --annot --row"}[kind],
                     *arch_flags(arch)])
    out = os.path.join(tmp, {"nb": "train"}.get(kind, kind)
                       + ("_hidden" if arch else ""))
    ck = out + "_ckpt"
    args = ["--mtx", mtx, "--batch_size", str(B_TRAIN), "--device", DEV,
            "--recording", "2", *arch_flags(arch)]
    if kind == "mixture":
        annot, row = write_annotation(tmp, marker_label())
        args += ["--annot", annot, "--row", row]
    reset_launches()
    t0 = time.time()
    err = run_cli(cli, args + ["--out", out, "--max_epoch", "2",
                               "--checkpoint_dir", ck])
    wall = time.time() - t0
    launches = read_launches()
    if (min(launches[k] for k in path) < 1 if path
            else any(launches.values())):
        raise AssertionError(f"the {name} main path skipped a kernel, or "
                             f"launched one off its path: {launches}")
    if "dense-resident" not in err:
        raise AssertionError(f"{name} did not run dense-resident")
    if ("Feature clustering: " in err) != (kind != "vmf"):
        raise AssertionError(f"{name}: feature clustering "
                             f"{'ran' if kind == 'vmf' else 'did not run'}")
    if route is not None and route not in step_line(err):
        raise AssertionError(f"{name}: route {step_line(err)!r}")
    scores = np.loadtxt(out + ".scores.gz", ndmin=1)
    if scores.shape != (2,) or not np.isfinite(scores).all():
        raise AssertionError(f"scores.gz: {scores}")
    # recording artifacts: the JAX CLI's names and shapes
    model = vmfnb_model(kind, **arch) if arch else model_and_step(kind)[0]
    names = flatten_params(model.init(torch.Generator().manual_seed(0)))
    want = {f"{out}_1.{k}.gz": (N_CLI, 2) for k in latent_names(model)}
    if kind == "mixture":
        want[f"{out}_1.clust.gz"] = (N_CLI, K_MIX)
    want.update({f"{out}_1_{k}.gz": v.shape for k, v in names.items()})
    for p, shape in want.items():
        a = np.loadtxt(p, ndmin=2)
        if a.shape != (shape if len(shape) == 2 else (shape[0], 1)) or \
                not np.isfinite(a).all():
            raise AssertionError(f"{p}: shape {a.shape}, want {shape}")
    rates = [ln.split("] ", 1)[-1] for ln in err.splitlines()
             if "cells/sec" in ln]
    log(f"{tag} [{card}] {name} CLI, {N_CLI} x {D_GENES}, 2 epochs: "
        f"scores {scores.tolist()}; {len(want)} recording artifacts with "
        f"the JAX CLI's names and shapes; kernel launches "
        f"{ {k: launches[k] for k in path} }; epochs: {' | '.join(rates)}; "
        f"CLI wall {wall:.2f}s")
    err = run_cli(cli, args + ["--out", out + "_r", "--max_epoch", "3",
                               "--resume", ck])
    s3 = np.loadtxt(out + "_r.scores.gz", ndmin=1)
    if (s3.shape != (3,) or not np.array_equal(s3[:2], scores)
            or not np.isfinite(s3).all() or "Resumed from" not in err):
        raise AssertionError(f"resume: scores {s3}")
    log(f"{tag} [{card}] --resume from the checkpoint ran epoch 3: "
        f"scores {s3.tolist()}")
    return launches, ck


def phase_joint_encode(card, tmp, mtx, ck, arch=None, tag="[phase 12]",
                       kind="joint"):
    """Phase 12 / 33, serving: ``encode --model vmfnb`` on the trained
    joint checkpoint (``kind`` "vmf": ``encode --model vmf`` on the
    vMF-VAE's, which launches no kernel), resident and streaming (bitwise
    equal), against the plain unfolded encoder on the card; ``arch``: a
    hidden-layer checkpoint's architecture (phase 24)."""
    from mmvae_tpu_torch.cli import encode
    from mmvae_tpu_torch.models.nb import params_from_numpy
    from mmvae_tpu_torch.train.checkpoint import load_checkpoint
    from mmvae_tpu_torch.train.recorder import latent_names

    arch = arch or {}
    vmf = kind == "vmf"
    args = ["--model", "vmf" if vmf else "vmfnb", "--mtx", mtx,
            "--checkpoint", ck, "--batch_size", "100", "--device", DEV,
            *arch_flags(arch)]
    reset_launches()
    t0 = time.time()
    err = run_cli(encode, args + ["--out", os.path.join(tmp, "jres")])
    wall = time.time() - t0
    counts = read_launches()
    launches = counts["count_encode[stats]"]
    if "dense-resident" not in err or (any(counts.values()) if vmf
                                       else launches < 1):
        raise AssertionError(f"{kind} resident sweep: launches {counts}")
    model = model_and_step("vmf")[0] if vmf else vmfnb_model("joint", **arch)
    names = latent_names(model)
    res = [np.loadtxt(os.path.join(tmp, f"jres.{k}.gz"), ndmin=2)
           for k in names]
    params = params_from_numpy(load_checkpoint(ck, model)[0], DEV)
    with torch.inference_mode():
        x = torch.from_numpy(read_mtx_dense(mtx)).to(DEV)
        plain = model.encode if vmf else model.shared_encode_mu
        want = [t.double().cpu().numpy() for t in plain(params, x)]
    worst = 0.0
    for got, w in zip(res, want):
        if got.shape != (N_CLI, 2) or not np.isfinite(got).all():
            raise AssertionError(f"bad {kind} encode output {got.shape}")
        # the fold reorders float32 sums over 20,000 genes: 1e-4 of the
        # output's scale, plus the %g text rounding (6 digits)
        lim = 1e-4 * np.abs(w).max() + 1e-5 * np.abs(w)
        worst = max(worst, float(np.max(np.abs(got - w) / lim)))
    if not worst <= 1.0:
        raise AssertionError(f"{kind} encode vs plain: err/tol {worst:.3g}")
    os.environ["MMVAE_DENSE_BYTES"] = "1"
    try:
        err = run_cli(encode, args + ["--out", os.path.join(tmp, "jstr")])
    finally:
        del os.environ["MMVAE_DENSE_BYTES"]
    if "resident fast path skipped" not in err:
        raise AssertionError(f"{kind} streaming sweep did not run")
    for k, a in zip(names, res):
        b = np.loadtxt(os.path.join(tmp, f"jstr.{k}.gz"), ndmin=2)
        if not np.array_equal(a, b):
            raise AssertionError(f"{kind} streaming {k} != resident")
    done = ("no kernel launches" if vmf
            else f"{launches} count_encode[stats] launches")
    log(f"{tag} [{card}] encode --model {args[1]} "
        f"{' '.join(arch_flags(arch))}: {done}; outputs ({N_CLI}, 2) "
        f".{names[0]} / .{names[1]} match the plain unfolded encoder "
        f"(err/tol {worst:.3g}; tol 1e-4 * max|ref| + 1e-5 * |ref|); "
        f"streaming equals resident bitwise; resident CLI wall {wall:.2f}s")
    return launches


def phase_mixture_encode(card, tmp, mtx, ck, arch=None, tag="[phase 16]"):
    """Phase 16, serving: ``encode --model mixture`` on the trained
    mixture checkpoint, resident and streaming (bitwise equal), against
    the plain unfolded encoder (``vmf_forward(training=False)`` +
    ``nb_encode_mu``) on the card with the CLI's Gumbel noise (seed 0);
    ``arch``: a hidden-layer checkpoint's architecture (phase 24)."""
    from mmvae_tpu_torch.cli import encode
    from mmvae_tpu_torch.models.nb import params_from_numpy
    from mmvae_tpu_torch.train.checkpoint import load_checkpoint

    arch = arch or {}
    annot, row = write_annotation(tmp, marker_label())
    args = ["--model", "mixture", "--mtx", mtx, "--checkpoint", ck,
            "--batch_size", str(B_TRAIN), "--annot", annot, "--row", row,
            "--device", DEV, *arch_flags(arch)]
    names = ("mu_mean", "mu_lnvar", "clust")
    reset_launches()
    t0 = time.time()
    err = run_cli(encode, args + ["--out", os.path.join(tmp, "mres")])
    wall = time.time() - t0
    launches = read_launches()["count_encode[filt]"]
    if "dense-resident" not in err or launches < 1:
        raise AssertionError(f"mixture resident sweep: {launches} launches")
    res = [np.loadtxt(os.path.join(tmp, f"mres.{k}.gz"), ndmin=2)
           for k in names]
    model = vmfnb_model("mixture", **arch)
    params = params_from_numpy(load_checkpoint(ck, model)[0], DEV)
    u = model.gumbel_uniforms(B_TRAIN, SEED)
    with torch.inference_mode():
        x = torch.from_numpy(read_mtx_dense(mtx)).to(DEV)
        vmf = model.vmf_forward(params, x, False, gumbel_u=u)
        mean, lnvar = model.nb_encode_mu(params, x, vmf.latent)
        g = -torch.log(-torch.log(u.double().to(DEV))).repeat(
            N_CLI // B_TRAIN, 1)
        top2 = torch.topk(vmf.logits.double() + g, 2, dim=1).values
        margin = (top2[:, 0] - top2[:, 1]).cpu().numpy()
        want = [t.double().cpu().numpy() for t in (mean, lnvar, vmf.latent)]
    for got, shape in zip(res, ((N_CLI, 2), (N_CLI, 2), (N_CLI, K_MIX))):
        if got.shape != shape or not np.isfinite(got).all():
            raise AssertionError(f"bad mixture encode output {got.shape}")
    # a flip of the hard draw needs the top two of logits + g within the
    # float32 error of the fold; elsewhere the assignments must agree
    same = res[2].argmax(1) == want[2].argmax(1)
    near = margin <= 1e-4
    if (~same & ~near).any() or near.sum() > N_CLI // 1000 + 1:
        raise AssertionError(f"mixture assignments: {int((~same).sum())} "
                             f"differ, {int(near.sum())} near-ties")
    worst = 0.0
    for got, w, rows in ((res[0], want[0], same), (res[1], want[1], None),
                         (res[2], want[2], same)):
        if rows is not None:
            got, w = got[rows], w[rows]
        # the fold reorders float32 sums over 20,000 genes: 1e-4 of the
        # output's scale, plus the %g text rounding (6 digits)
        lim = 1e-4 * np.abs(w).max() + 1e-5 * np.abs(w)
        worst = max(worst, float(np.max(np.abs(got - w) / lim)))
    if not worst <= 1.0:
        raise AssertionError(f"mixture encode vs plain: err/tol {worst:.3g}")
    os.environ["MMVAE_DENSE_BYTES"] = "1"
    try:
        err = run_cli(encode, args + ["--out", os.path.join(tmp, "mstr")])
    finally:
        del os.environ["MMVAE_DENSE_BYTES"]
    if "resident fast path skipped" not in err:
        raise AssertionError("mixture streaming sweep did not run")
    for k, a in zip(names, res):
        b = np.loadtxt(os.path.join(tmp, f"mstr.{k}.gz"), ndmin=2)
        if not np.array_equal(a, b):
            raise AssertionError(f"mixture streaming {k} != resident")
    counts = np.bincount(res[2].argmax(1), minlength=K_MIX).tolist()
    log(f"{tag} [{card}] encode --model mixture "
        f"{' '.join(arch_flags(arch))}: {launches} "
        f"count_encode[filt] launches; outputs ({N_CLI}, 2), ({N_CLI}, 2), "
        f"({N_CLI}, {K_MIX}) match the plain unfolded encoder with the same "
        f"noise (assignments equal on {int(same.sum())} of {N_CLI} rows, "
        f"{int(near.sum())} near-ties; err/tol {worst:.3g}; tol 1e-4 * "
        f"max|ref| + 1e-5 * |ref|); cells per component {counts}; streaming "
        f"equals resident bitwise; CLI wall {wall:.2f}s")
    return launches


def phase_train_full(card, data, kind="nb"):
    """Phase 9 (NB) / 13 (joint) / 17 (mixture) / 21 (NB on the generic
    step, ``nb_vae --no_fused_step``) / 25 (the joint model's library
    trainer, K2pv's main path) / 34 (the vMF-VAE's packed step): two
    epochs of the dense-resident epoch runner at full width over the
    first N_EARLIER cells (N_VMF for the vMF-VAE, N_SHORT for the joint
    and mixture models and the generic steps), with the kernels' launches per batch (none for the vMF-VAE,
    whose kappa is printed before and after), and a profile of 20 batches
    (processing a trace takes about a second a batch, the largest cost
    of these phases)."""
    from mmvae_tpu_torch.train.config import TrainingOptions
    from mmvae_tpu_torch.train.loop import DenseEpochRunner

    tag = f"[phase {PHASE[kind]['full']}]"
    data = data[:{"nb": N_EARLIER, "vmf": N_VMF}.get(kind, N_SHORT)]
    if kind == "generic":
        model = model_and_step("nb")[0]
        fast = generic_trainer(model, TrainingOptions(fused_step=False))
    elif kind == "library":
        model = vmfnb_model("joint")
        fast = vmfnb_trainer(model, TrainingOptions(), library=True)
    else:
        model, step_cls = model_and_step(kind)
        fast = step_cls(model, TrainingOptions())
    params = model.init(torch.Generator().manual_seed(SEED), device=DEV)
    # the eager per-batch path (phase 43 runs the superbatch graphs)
    runner = DenseEpochRunner(fast, data, B_TRAIN, seed=SEED,
                              superbatch=None)
    q = fast.pack(params)
    po = fast.optimizer.init(q)
    losses, times, reps_all = [], [], []
    reset_launches()
    for epoch in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        q, po, reps, _ = runner(q, po, epoch)
        reps_all.append(reps)
        # in float64: the vMF loss at D = 20,000 is ~7e4, where one
        # float32 ulp (0.0078) is the size of its fall over two epochs
        losses.append(reps.double().mean().item())
        times.append(time.perf_counter() - t0)
    per = {k: n / (2 * runner.nbatch) for k, n in read_launches().items()
           if n}
    # the trained state, before the profile below steps on: phase 36's
    # reference
    result = {"rate": data.shape[0] / times[1], "reps": reps_all,
              "params": clone_tree(fast.unpack(q))}
    if not (np.isfinite(losses).all() and losses[1] < losses[0]):
        raise AssertionError(f"full-size training loss {losses}")
    extra = ""
    if kind == "vmf":
        if per:
            raise AssertionError(f"the vMF step launched a kernel: {per}")
        ln = (params["ln_kappa"].item(), fast.unpack(q)["ln_kappa"].item())
        kap = [model.kappa(torch.tensor([v])).item() for v in ln]
        extra = (f"; ln_kappa {ln[0]:.6f} -> {ln[1]:.6f} (kappa "
                 f"{kap[0]:.6f} -> {kap[1]:.6f}, clamp [{model.kappa_min}, "
                 f"{model.kappa_max}])")
    N = data.shape[0]
    log(f"{tag} [{card}] {kind} training {N} x "
        f"{D_GENES} int8, B={B_TRAIN}, nboot 3: epoch losses "
        f"{losses[0]:.4f} -> {losses[1]:.4f}; epoch times {times[0]:.2f}s, "
        f"{times[1]:.2f}s; second epoch {N / times[1]:,.1f} cells/sec; "
        f"kernel launches a batch {per}{extra}")
    nprof = 20
    sub = DenseEpochRunner(fast, data[:nprof * B_TRAIN], B_TRAIN, seed=SEED,
                           superbatch=None)
    rand = sub.draw(2)
    busy, per = device_profile(lambda: sub(q, po, 2, rand=rand))
    per_batch = times[1] * 1e3 / runner.nbatch
    top = sorted(per.items(), key=lambda kv: -kv[1])[:8]
    # device time by the port's kernel (trace_step's map: both stages of
    # a kernel, every instance), PyTorch's own as "torch"
    from mmvae_tpu_torch.benchmarks.trace_step import port_kernel
    by = {}
    for k, v in per.items():
        by[port_kernel(k)] = by.get(port_kernel(k), 0.0) + v / nprof
    # (a trace that lost kernels fell back to CUDA events: no split)
    if kind == "generic" and device_profile.kernels and min(
            by.get("nb_elbo_fwd", 0.0), by.get("nb_elbo_bwd", 0.0)) <= 0:
        raise AssertionError(f"the generic step's profile credits no time "
                             f"to K7 or K8: {by}")
    log(f"{tag} [{card}] profile of {nprof} batches: device busy "
        f"{busy / nprof:.3f} ms per batch in "
        f"{device_profile.kernels / nprof:.0f} device kernels and copies, "
        f"against {per_batch:.3f} ms wall per batch of the unprofiled "
        f"second epoch (device idle share "
        f"{1 - busy / nprof / per_batch:.1%}); ms a batch by the port's "
        f"kernel: " + ", ".join(f"{k} {v:.4f}" for k, v in sorted(
            by.items(), key=lambda kv: -kv[1]))
        + f"; top kernels over the {nprof} batches: "
        + "; ".join(f"{k[:48]} {v:.1f} ms" for k, v in top))
    return result


def clone_tree(tree: dict) -> dict:
    return {k: clone_tree(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


# ----------------------------------------------------------------------
# the vMF-VAE (32-34, and its serving sweep in 5): plain PyTorch, as the
# JAX package computes it in XLA, so its path launches no kernel of the
# port; every launch counter is read after each of its runs
# ----------------------------------------------------------------------

def phase_vmf_step(card):
    """Phase 32: one vMF-VAE batch step on the card at B = 100, D = 20,000
    int8 counts, the packed ``VMFFastStep`` against the generic
    ``Trainer`` (``forward`` + ``vmf_loss``, the route ``--no_fused_step``
    takes) with the same draws, at the JAX suite's contract for the two
    (tests/test_vmf_fast.py:76-80): the report rtol 2e-4, every parameter
    rtol 3e-3, atol 1e-4.  Then int8 == int16 == float32 storage of the
    same counts and two runs, bitwise; every kernel's launch counter
    stays at 0."""
    from mmvae_tpu_torch.cli.vmf_vae import make_step
    from mmvae_tpu_torch.ops.nb_fast import batch_rand, tree_leaves
    from mmvae_tpu_torch.train.config import TrainingOptions

    tag = "[phase 32]"
    g = torch.Generator(device=DEV).manual_seed(SEED + 32)
    model, step_cls = model_and_step("vmf")
    params = random_params(model, DEV)
    x8 = make_counts(g, B_TRAIN, D_GENES, torch.int8)
    c = torch.ones((B_TRAIN, 1), device=DEV)
    packed = step_cls(model, TrainingOptions())
    generic, route = make_step(model, TrainingOptions(fused_step=False))
    rand = batch_rand(packed.draw_rand(
        torch.Generator(device=DEV).manual_seed(SEED + 5), 1, B_TRAIN), 0)

    def run(step, x):
        q = step.pack(params)
        q2, _, rep = step.batch_step(q, step.optimizer.init(q), x, c, 0.0,
                                     rand)
        torch.cuda.synchronize()
        return step.unpack(q2), rep.item()

    reset_launches()
    (pk, rk), (pg, rg) = run(packed, x8), run(generic, x8)
    launched = {k: n for k, n in read_launches().items() if n}
    if launched:
        raise AssertionError(f"the vMF step launched kernels: {launched}")
    rep_err = abs(rk - rg) / abs(rg)
    if not rep_err <= 2e-4:
        raise AssertionError(f"vMF report: packed {rk} vs generic {rg}")
    q_p = max(((a - b).abs() / (3e-3 * b.abs() + 1e-4)).max().item()
              for a, b in zip(tree_leaves(pk), tree_leaves(pg)))
    if not q_p <= 1.0:
        raise AssertionError(f"vMF packed vs generic: params err/tol "
                             f"{q_p:.3g}")
    for name, x in (("int16", x8.to(torch.int16)),
                    ("float32", x8.float()), ("int8 again", x8)):
        p2, r2 = run(packed, x)
        if not (r2 == rk and all(torch.equal(u, v) for u, v in zip(
                tree_leaves(p2), tree_leaves(pk)))):
            raise AssertionError(f"vMF packed step: {name} != int8 bitwise")
    log(f"{tag} [{card}] one vMF batch step, B={B_TRAIN} D={D_GENES} int8, "
        f"packed step vs {route} with the same draws: report {rk:.6f} vs "
        f"{rg:.6f} (rel {rep_err:.2g}, tol 2e-4); every parameter err/tol "
        f"{q_p:.3g} (rtol 3e-3, atol 1e-4); int8 == int16 == float32 "
        f"storage and two runs bitwise; no kernel launched")


def phase_vmf_cli(card, tmp, mtx):
    """Phase 33: the vMF-VAE's CLIs end to end on phase 4's matrix, every
    launch counter reset just before each run and read just after (all
    stay 0): ``vmf_vae`` for 2 epochs with recording and a checkpoint,
    then ``--resume`` for one more (:func:`phase_train_cli`); ``vmf_vae
    --encoding 16 --decoding 16`` (the generic step) for one epoch;
    ``encode --model vmf`` on the first checkpoint, resident and
    streaming (bitwise equal), against the plain unfolded encoder
    (:func:`phase_joint_encode`).  Width 16 is a test width: the
    reference publishes no hidden-layer default."""
    from mmvae_tpu_torch.cli import vmf_vae

    tag = "[phase 33]"
    launches, ck = phase_train_cli(card, tmp, mtx, "vmf",
                                   route="packed step (VMFFastStep)")
    reset_launches()
    hidden = dict(encoding=(16,), decoding=(16,))
    err = run_cli(vmf_vae, ["--mtx", mtx, "--batch_size", str(B_TRAIN),
                            "--device", DEV, "--max_epoch", "1",
                            *arch_flags(hidden), "--out",
                            os.path.join(tmp, "vmf_hidden")])
    n = read_launches()
    route = step_line(err)
    score = np.loadtxt(os.path.join(tmp, "vmf_hidden.scores.gz"), ndmin=1)
    if ("generic step, forward + vmf_loss" not in route or any(n.values())
            or score.shape != (1,) or not np.isfinite(score).all()):
        raise AssertionError(f"vmf_vae hidden: route {route!r}, launches "
                             f"{n}, score {score}")
    log(f"{tag} [{card}] vmf_vae {' '.join(arch_flags(hidden))}, 1 epoch: "
        f"step {route!r}; score {score.tolist()}; no kernel launched; "
        + [ln.split("] ", 1)[-1] for ln in err.splitlines()
           if "cells/sec" in ln][-1])
    phase_joint_encode(card, tmp, mtx, ck, tag=tag, kind="vmf")
    return launches


def phase_full_vmf(card, data):
    """Phase 5, the vMF-VAE: the resident serving sweep (the folded
    Angular encoder, plain PyTorch) over the same 100,000 x 20,000 int8
    counts, with random parameters; the first 1000 rows against the
    unfolded ``encode``; no kernel launched."""
    from mmvae_tpu_torch.train.loop import encode_resident

    N, B, chunk = N_FULL, 100, 16
    model = model_and_step("vmf")[0]
    params = random_params(model, DEV)
    reset_launches()
    with torch.inference_mode():
        encode_resident(model, params, data, B, chunk)  # warm-up
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mean, lnvar = encode_resident(model, params, data, B, chunk)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        busy, per = device_profile(
            lambda: encode_resident(model, params, data, B, chunk))
        want = model.encode(params, data[:1000])
    launched = {k: n for k, n in read_launches().items() if n}
    if launched:
        raise AssertionError(f"the vMF sweep launched kernels: {launched}")
    worst = 0.0
    for got, w in zip((mean[:1000], lnvar[:1000]), want):
        w = w.double()
        lim = 1e-4 * w.abs().max() + 1e-5 * w.abs()
        worst = max(worst, ((got.double() - w).abs() / lim).max().item())
    if not (worst <= 1.0 and mean.shape == (N, 2)
            and torch.isfinite(mean).all() and torch.isfinite(lnvar).all()):
        raise AssertionError(f"vMF sweep vs plain: err/tol {worst:.3g}")
    dt = statistics.median(times)
    top = sorted(per.items(), key=lambda kv: -kv[1])[:4]
    log(f"[phase 5] [{card}] vMF resident sweep {N} x {D_GENES} int8, "
        f"B={B}, chunk {chunk}: {N / dt:,.1f} cells/sec (median of 3: "
        f"{', '.join(f'{t * 1e3:.3f}' for t in times)} ms); device busy "
        f"{busy:.3f} ms of {dt * 1e3:.3f} ms wall (idle share "
        f"{1 - busy / (dt * 1e3):.1%}) in {device_profile.kernels:.0f} "
        f"device kernels and copies; first 1000 rows match the unfolded "
        f"encoder (err/tol {worst:.3g}; tol 1e-4 * max|ref| + 1e-5 * "
        f"|ref|); no kernel of the port launched; "
        + "; ".join(f"{k[:60]} {v:.3f} ms" for k, v in top))


# ----------------------------------------------------------------------
# the data tiers beyond the dense budget (35-36): every tier gives the
# dense-resident tier's batches and draws, so its bits
# ----------------------------------------------------------------------

@contextlib.contextmanager
def environ(**env):
    """``os.environ`` with ``env`` set, restored after."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v


def run_outputs(out: str) -> dict:
    """A trainer CLI run's ``scores.gz`` and recording artifacts (their
    decompressed text: the gzip header holds the file's name) and its
    checkpoint's arrays."""
    d, base = os.path.split(out)
    pat = re.compile(re.escape(base) + r"(_\d.*|\.scores)\.gz$")
    got = {}
    for f in sorted(os.listdir(d)):
        m = pat.match(f)
        if m:
            with gzip.open(os.path.join(d, f)) as fh:
                got[m.group(1)] = fh.read()
    with np.load(os.path.join(out + "_ckpt", "ckpt.npz")) as z:
        got.update({k: z[k] for k in z.files if k != "__meta__"})
    return got


def same_outputs(got: dict, want: dict) -> bool:
    return got.keys() == want.keys() and all(
        np.array_equal(got[k], want[k]) if isinstance(got[k], np.ndarray)
        else got[k] == want[k] for k in got)


# (label, environment, flags, the line the tier logs); shard budgets
# scaled to phase 4's 4,000 cells (40 batches): dense batches are 2 MB,
# ELL and CSR batches a few hundred kB
TIER_RUNS = [
    ("ELL-resident", {"MMVAE_DENSE_BYTES": "1", "MMVAE_ROTATE": "0"}, [],
     "Loading data on device (ELL layout)"),
    ("rotation, dense layout", {"MMVAE_DENSE_BYTES": "1",
                                "MMVAE_SHARD_LAYOUT": "dense",
                                "MMVAE_SHARD_BYTES": str(20 << 20)}, [],
     "dense layout"),
    ("rotation, ell layout", {"MMVAE_DENSE_BYTES": "1",
                              "MMVAE_SHARD_LAYOUT": "ell",
                              "MMVAE_SHARD_BYTES": str(1 << 20)}, [],
     "ell layout"),
    ("rotation, csr layout", {"MMVAE_DENSE_BYTES": "1",
                              "MMVAE_SHARD_LAYOUT": "csr",
                              "MMVAE_SHARD_BYTES": str(1 << 20)}, [],
     "csr layout"),
    ("rotation, half resident", {"MMVAE_DENSE_BYTES": "1",
                                 "MMVAE_SHARD_LAYOUT": "dense",
                                 "MMVAE_SHARD_BYTES": str(20 << 20),
                                 "MMVAE_PIN_BYTES": str(40 << 20)}, [],
     "Rotating 2/4 host-resident shards"),
    ("--data_mode stream", {}, ["--data_mode", "stream"], "cells/sec)"),
    ("--no_auto_ondevice", {}, ["--no_auto_ondevice"], "cells/sec)"),
]
CSR_ENV = TIER_RUNS[3][1]


def tier_run(cli, args, out, env, line, path):
    """One trainer CLI run on a tier with every launch counter reset just
    before and read just after: the tier's log line, the kernels of
    ``path`` launched (none at all for an empty path), at least 4 shards
    when it rotates.  Returns (outputs, launches, the tier's line, the
    epoch-2 rate)."""
    reset_launches()
    with environ(**env):
        err = run_cli(cli, args + ["--out", out, "--checkpoint_dir",
                                   out + "_ckpt"])
    launches = read_launches()
    if line not in err or "dense-resident" in err:
        raise AssertionError(f"{out}: the run did not log {line!r}")
    if (min(launches[k] for k in path) < 1 if path
            else any(launches.values())):
        raise AssertionError(f"{out}: launches {launches}")
    tier = next((ln.split("] ", 1)[-1] for ln in err.splitlines()
                 if "host-resident shards" in ln or "ELL layout" in ln),
                "host path (no on-device line)")
    m = re.search(r"Rotating (\d+)/(\d+) ", err)
    if m and int(m.group(2)) < 4:
        raise AssertionError(f"{out}: {m.group(0)}: fewer than 4 shards")
    rate = [ln.split("(", 1)[-1].split(" cells/sec")[0]
            for ln in err.splitlines() if "cells/sec" in ln][-1]
    return run_outputs(out), launches, tier, rate


def phase_tiers(card, tmp, mtx):
    """Phase 35: ``nb_vae`` on phase 4's matrix, 2 epochs with recording
    and a checkpoint, on every tier beyond the dense-resident one (ELL,
    rotation in the dense, ell and csr layouts with 4 or more shards, with
    half the shards resident, ``--data_mode stream``, ``--no_auto_ondevice``),
    each equal to phase 42's unclustered dense-resident run
    (``MMVAE_FEATURE_PERM=0``: the tiers never cluster) bitwise
    (scores.gz, the artifacts' text, the checkpoint's arrays) with every
    NB kernel launched; ``--resume`` from a rotating run's epoch-1
    checkpoint equal to the uninterrupted run; then ``vmfnb_vae``,
    ``vmfnb_vae --annot --row`` and ``vmf_vae`` on rotation (csr) against
    phase 42's unclustered runs and phase 33's dense-resident run (the
    vMF-VAE launching no kernel)."""
    from mmvae_tpu_torch.cli import nb_vae, vmf_vae, vmfnb_vae

    tag = "[phase 35]"
    args = ["--mtx", mtx, "--batch_size", str(B_TRAIN), "--device", DEV,
            "--recording", "2", "--max_epoch", "2"]
    want = run_outputs(os.path.join(tmp, "train_flat"))
    t0 = time.time()
    for i, (label, env, flags, line) in enumerate(TIER_RUNS):
        got, launches, tier, rate = tier_run(
            nb_vae, args + flags, os.path.join(tmp, f"tier{i}"), env, line,
            NB_PATH)
        if not same_outputs(got, want):
            raise AssertionError(f"{label}: outputs differ from the "
                                 f"dense-resident run")
        log(f"{tag} [{card}] nb_vae on {label}: {tier}; {len(got)} outputs "
            f"equal phase 42's unclustered dense-resident run bitwise; "
            f"launches "
            f"{ {k: launches[k] for k in NB_PATH} }; epoch 2 {rate} "
            f"cells/sec")
    # a checkpoint written while the next epoch's first shard is copied
    out = os.path.join(tmp, "tier_resume")
    a = args[:-1] + ["1"]
    with environ(**CSR_ENV):
        run_cli(nb_vae, a + ["--out", out + "1", "--checkpoint_dir",
                             out + "1_ckpt"])
        err = run_cli(nb_vae, args + ["--out", out, "--checkpoint_dir",
                                      out + "_ckpt", "--resume",
                                      out + "1_ckpt"])
    if "Resumed from" not in err or not same_outputs(run_outputs(out), want):
        raise AssertionError("--resume from a rotating epoch-1 checkpoint "
                             "differs from the uninterrupted run")
    log(f"{tag} [{card}] nb_vae --resume from the csr rotating run's epoch-1 "
        f"checkpoint (written while the next shard's copy was in flight) "
        f"equals the uninterrupted run bitwise")
    for kind, cli in (("joint", vmfnb_vae), ("mixture", vmfnb_vae),
                      ("vmf", vmf_vae)):
        extra = []
        if kind == "mixture":
            extra = ["--annot", os.path.join(tmp, "markers.txt"), "--row",
                     os.path.join(tmp, "genes.txt")]
        got, launches, tier, rate = tier_run(
            cli, args + extra, os.path.join(tmp, f"tier_{kind}"), CSR_ENV,
            "csr layout", PATHS[kind])
        ref = kind if kind == "vmf" else kind + "_flat"
        if not same_outputs(got, run_outputs(os.path.join(tmp, ref))):
            raise AssertionError(f"{kind} on rotation differs from its "
                                 f"dense-resident run")
        done = ({k: launches[k] for k in PATHS[kind]} if PATHS[kind]
                else "no kernel launched")
        name = {"joint": "vmfnb_vae", "mixture": "vmfnb_vae --annot --row",
                "vmf": "vmf_vae"}[kind]
        log(f"{tag} [{card}] {name} on rotation (csr): {tier}; "
            f"{len(got)} outputs equal "
            + ("phase 33's" if kind == "vmf" else "phase 42's unclustered")
            + f" dense-resident run bitwise; launches "
            f"{done}; epoch 2 {rate} cells/sec")
    log(f"{tag} [{card}] {len(TIER_RUNS) + 5} trainer runs in "
        f"{time.time() - t0:.1f}s")


# ----------------------------------------------------------------------
# feature clustering (phase 42)
# ----------------------------------------------------------------------

# a clustered run against its MMVAE_FEATURE_PERM=0 run, at the JAX
# suite's tolerances (tests/test_feature_perm.py): the sums over the
# genes reassociate, nothing else changes.  An output is held where the
# unclustered code itself determines it to within them: where its packed
# step and its --no_fused_step route (another order of the same sums, on
# the same draws) agree within them.  The rest (the joint model's kappa
# head, whose float32 gradient is mostly cancellation, and the
# mixture's posteriors, ~40x the tolerance apart between the two routes
# on the card) random-walk under any reordering of a sum: they are
# reported beside that route gap
CLUSTER_TOL = ("scores |c - u| <= 2e-4 |u|; every artifact and checkpoint "
               "parameter |c - u| <= 2e-3 |u| + 2e-4; .clust.gz >= 95% "
               "equal; each held where packed and --no_fused_step, both "
               "unclustered, agree within it")
# an output's limit in output_errors' units
CLUSTER_LIMIT = {".scores": 2e-4, ".clust": 0.05}
# (model, the output name of its phase 8, 12 or 16 run)
CLUSTER_RUNS = (("nb", "train"), ("joint", "joint"), ("mixture", "mixture"))
PROBE_BATCHES = 4  # the batches of phase 4's matrix phase 42 times K2, K6, K3 on


def output_errors(got: dict, want: dict) -> dict:
    """{output: err/tol} of a run's :func:`run_outputs` against another's:
    the scores' largest |a - u| / |u| (``.scores``), the share of unequal
    entries of ``.clust.gz`` (``.clust`` keys), and for every other
    artifact and checkpoint parameter the largest |a - u| / (2e-3 |u| +
    2e-4); the Adam state and the checkpoint's bookkeeping are left
    out."""
    if got.keys() != want.keys():
        raise AssertionError(f"outputs differ: "
                             f"{sorted(got.keys() ^ want.keys())}")
    out = {}
    for k, u in want.items():
        if isinstance(u, bytes):
            a = np.loadtxt(io.BytesIO(got[k]), ndmin=1)
            u = np.loadtxt(io.BytesIO(u), ndmin=1)
        elif k.startswith("params/"):
            a = got[k]
        else:
            continue
        if a.shape != u.shape:
            raise AssertionError(f"{k}: shape {a.shape} vs {u.shape}")
        if k == ".scores":
            out[k] = float(np.max(np.abs(a - u) / np.abs(u)))
        elif k.endswith(".clust"):
            out[k] = float(np.mean(a != u))
        else:
            out[k] = float(np.max(np.abs(a - u) / (2e-3 * np.abs(u) + 2e-4),
                                  initial=0.0))
    return out


def probe_clustering(card, mtx):
    """Phase 42's ``benchmarks.perm_probe`` on phase 4's matrix: the hot
    genes, the regime shares a batch in input and cold-first order, and
    K2, K6 and K3 on the first :data:`PROBE_BATCHES` batches in both
    orders (random decoder operands from the seed, the same in both
    orders, W's columns permuted with the counts), each held against its
    plain version at phase 6's tolerance, device ms by CUDA events around
    CUDA graph replays (``perm_probe.device_ms``)."""
    from mmvae_tpu_torch.benchmarks import perm_probe as pp
    from mmvae_tpu_torch.data.block import MtxMemoryBlock
    from mmvae_tpu_torch.train.loop import build_dense, hot_genes

    tag = "[phase 42]"
    x = build_dense(MtxMemoryBlock(mtx, mtx + ".index", B_TRAIN,
                                   count_dtype="auto"), DEV)
    hot = hot_genes(x)
    log(f"{tag} [{card}] perm_probe on phase 4's {N_CLI} x {D_GENES} "
        f"{str(x.dtype).replace('torch.', '')} matrix: {int(hot.sum())} hot "
        f"genes (a count > 7), {100 * hot.mean():.2f}%")
    res = {}
    for name, o in (("input", np.arange(D_GENES)),
                    ("cold-first", np.argsort(hot, kind="stable"))):
        oi = torch.from_numpy(o).to(DEV)
        xo = x.index_select(1, oi)
        shares = pp.regime_shares(xo, B_TRAIN)
        g = torch.Generator(device=DEV).manual_seed(SEED + 42)
        ms = dict.fromkeys(("nb_valgrad", "nb_value", "nb_finish"), 0.0)
        worst = dict.fromkeys(ms, 0.0)
        for b in range(PROBE_BATCHES):
            rows = slice(b * B_TRAIN, (b + 1) * B_TRAIN)
            zc, zn, depth, W = pp.batch_operands(x[rows], g)
            W = W.index_select(1, oi).contiguous()
            xb = xo[rows]
            bounds = step_kernel_bounds(xb, zc, zn, depth, W, pp.WIDTHS)
            for k, (kern, plain) in pp.kernel_calls(xb, zc, zn, depth,
                                                    W).items():
                got, want = kern(), plain()
                got = got if isinstance(got, tuple) else (got,)
                want = want if isinstance(want, tuple) else (want,)
                for gt, wt, S in zip(got, want, bounds[k]):
                    _, q = ratio(gt, wt, S)
                    if not q <= 1.0:
                        raise AssertionError(f"{tag} {k} in {name} order, "
                                             f"batch {b}: err/tol {q:.3g}")
                    worst[k] = max(worst[k], q)
                ms[k] += pp.device_ms(kern) / PROBE_BATCHES
        res[name] = ms
        log(f"{tag} [{card}] {name} order: {shares['pairs']} (batch, "
            f"64-column tile) pairs of B = {B_TRAIN}: "
            + ", ".join(f"{r} {100 * shares[r]:.2f}%" for r in pp.REGIMES)
            + f"; kernel device ms a call on batches 1-{PROBE_BATCHES} (CUDA "
            f"graph replays), err/tol against plain at phase 6's tolerance: "
            + "; ".join(f"{k} {v:.4f} ({worst[k]:.3g})"
                        for k, v in ms.items()))
    log(f"{tag} [{card}] cold-first / input, kernel ms: " + ", ".join(
        f"{k} {res['cold-first'][k] / res['input'][k]:.3f}"
        for k in res["input"]))


def writer_runs(card, tmp, mtx):
    """Phase 42's recorder with its background writer and without:
    ``train_vae_model`` as ``nb_vae`` drives it (packed step, clustered,
    dense-resident) on phase 4's matrix, 4 epochs recording every 2, in
    turns off / on / on / off; every run's decompressed files equal the
    first's."""
    from mmvae_tpu_torch.data.block import MtxDataBlock, MtxMemoryBlock
    from mmvae_tpu_torch.models.nb import NBVAE
    from mmvae_tpu_torch.ops.nb_fast import NBFastStep
    from mmvae_tpu_torch.train.config import TrainingOptions
    from mmvae_tpu_torch.train.loop import train_vae_model
    from mmvae_tpu_torch.train.recorder import LatentRecorder

    tag = "[phase 42]"
    cov = os.path.join(tmp, "train.covar.mtx.gz")  # phase 8's
    data = MtxMemoryBlock(mtx, mtx + ".index", B_TRAIN, count_dtype="auto")
    covar = MtxDataBlock(cov, cov + ".index", B_TRAIN)
    covar.auto_ones = True
    os.makedirs(os.path.join(tmp, "writer"))
    files, rows = [], {False: [], True: []}
    for i, on in enumerate((False, True, True, False)):
        out = os.path.join(tmp, "writer", f"run{i}")
        model = NBVAE(data_dim=D_GENES)
        topt = TrainingOptions(max_epoch=4, recording=2, seed=SEED)
        rec = LatentRecorder(out, 4, N_CLI, encode_fn=model.encode_mu,
                             async_writes=on)
        reset_launches()
        train_vae_model(NBFastStep(model, topt), rec, data, covar, topt,
                        model.init(torch.Generator().manual_seed(SEED),
                                   device=DEV), DEV,
                        metrics_path=out + ".metrics.jsonl",
                        feature_perm=True)
        launches = read_launches()
        if min(launches[k] for k in NB_PATH) < 1:
            raise AssertionError(f"{tag} writer run {i}: {launches}")
        got = {}
        for f in sorted(os.listdir(os.path.dirname(out))):
            if f.startswith(f"run{i}_") and f.endswith(".gz"):
                with gzip.open(os.path.join(os.path.dirname(out), f)) as fh:
                    got[f[len(f"run{i}"):]] = fh.read()
        files.append(got)
        with open(out + ".metrics.jsonl") as fh:
            rows[on].append([json.loads(ln) for ln in fh])
    if len(files[0]) != 2 * 28 or any(f != files[0] for f in files):
        raise AssertionError(f"{tag} the writer's files differ from the "
                             f"synchronous recorder's")

    def col(on, key, epoch):
        return "/".join(f"{r[epoch].get(key, 0.0):,.4g}" for r in rows[on])

    log(f"{tag} [{card}] train_vae_model (nb_vae's packed step, clustered) "
        f"on phase 4's matrix, 4 epochs recording epochs 2 and 4, writer off"
        f" / on / on / off: {len(files[0])} decompressed files equal in "
        f"every run; " + "; ".join(
            f"writer {'on' if on else 'off'} (two runs): cells/sec by epoch "
            + ", ".join(col(on, "cells_per_sec", e) for e in range(4))
            + f"; time_record_submit epoch 2 {col(on, 'time_record_submit', 1)}"
            f" s, epoch 4 {col(on, 'time_record_submit', 3)} s; time_step "
            f"epoch 3 {col(on, 'time_step', 2)} s" for on in (False, True)))


def phase_feature_perm(card, tmp, mtx):
    """Phase 42: :func:`probe_clustering`; the unclustered references of
    ``nb_vae``, ``vmfnb_vae`` and ``vmfnb_vae --annot --row``
    (``MMVAE_FEATURE_PERM=0``, phase 8, 12 and 16's flags; phases 35 and
    37 compare with them) and of ``--no_fused_step``; phase 8, 12 and
    16's clustered runs match the first within :data:`CLUSTER_TOL` on
    every output on which the two agree within it (the rest reported
    beside their gap); each clustered model for one epoch with a
    checkpoint, resumed to two and equal to phase 8, 12 or 16's run
    bitwise; every run of the packed step with every kernel of its path
    launched; then :func:`writer_runs`."""
    from mmvae_tpu_torch.cli import nb_vae, vmfnb_vae

    tag = "[phase 42]"
    t0 = time.time()
    probe_clustering(card, mtx)
    annot, row = write_annotation(tmp, marker_label())
    for kind, name in CLUSTER_RUNS:
        cli = nb_vae if kind == "nb" else vmfnb_vae
        label = {"nb": "nb_vae", "joint": "vmfnb_vae",
                 "mixture": "vmfnb_vae --annot --row"}[kind]
        args = ["--mtx", mtx, "--batch_size", str(B_TRAIN), "--device", DEV,
                "--recording", "2"]
        if kind == "mixture":
            args += ["--annot", annot, "--row", row]
        out = os.path.join(tmp, name)
        errs = {}
        for run, env, extra in (
                ("_flat", {"MMVAE_FEATURE_PERM": "0"}, ["--max_epoch", "2"]),
                ("_gen", {"MMVAE_FEATURE_PERM": "0"},
                 ["--max_epoch", "2", "--no_fused_step"]),
                ("_c1", {}, ["--max_epoch", "1"]),
                ("_cr", {}, ["--max_epoch", "2", "--resume",
                             out + "_c1_ckpt"])):
            reset_launches()
            with environ(**env):
                err = run_cli(cli, args + extra + [
                    "--out", out + run, "--checkpoint_dir",
                    out + run + "_ckpt"])
            launches = read_launches()
            if run != "_gen" and min(launches[k] for k in PATHS[kind]) < 1:
                raise AssertionError(f"{tag} {label}{run}: {launches}")
            if ("dense-resident" not in err
                    or ("Feature clustering: " in err)
                    != (run in ("_c1", "_cr"))):
                raise AssertionError(f"{tag} {label}{run}: not dense-resident"
                                     f" or clustering as not asked")
            errs[run] = err
        flat = run_outputs(out + "_flat")
        e_c = output_errors(run_outputs(out), flat)
        e_g = output_errors(run_outputs(out + "_gen"), flat)

        def limit(k):
            return CLUSTER_LIMIT.get(k, CLUSTER_LIMIT[".clust"]
                                     if k.endswith(".clust") else 1.0)

        held = [k for k in e_c if e_g[k] <= limit(k)]
        bad = [k for k in held if not e_c[k] <= limit(k)]
        if bad:
            raise AssertionError(f"{tag} {label}: clustered vs unclustered "
                                 f"beyond {CLUSTER_TOL}: " + ", ".join(
                                     f"{k} {e_c[k]:.3g} (route gap "
                                     f"{e_g[k]:.3g})" for k in bad))
        if ("Resumed from" not in errs["_cr"]
                or not same_outputs(run_outputs(out + "_cr"),
                                    run_outputs(out))):
            raise AssertionError(f"{tag} {label} --resume differs from the "
                                 f"uninterrupted clustered run")
        line = next(ln.split("] ", 1)[-1] for ln in errs["_c1"].splitlines()
                    if "Feature clustering: " in ln)
        worst = max((e_c[k] / limit(k), k) for k in held)
        free = sorted((k for k in e_c if k not in held),
                      key=lambda k: -e_c[k])
        log(f"{tag} [{card}] {label}: {line!r}; phase "
            f"{PHASE[kind]['cli']}'s clustered run against "
            f"MMVAE_FEATURE_PERM=0 ({CLUSTER_TOL}): scores rel "
            f"{e_c['.scores']:.3g} (route gap {e_g['.scores']:.3g}), "
            f"{len(held)} of {len(e_c)} outputs held, the worst at "
            f"{worst[0]:.3g} of its limit ({worst[1]})"
            + (f", .clust.gz {100 * (1 - e_c['_1.clust']):.2f}% equal"
               if kind == "mixture" else "")
            + ("; not held (err/tol clustered | route gap): " + ", ".join(
                f"{k} {e_c[k]:.3g} | {e_g[k]:.3g}" for k in free)
               if free else "; every output held")
            + f"; one clustered epoch resumed to two equals phase "
            f"{PHASE[kind]['cli']}'s run bitwise; launches of the resumed "
            f"run { {k: launches[k] for k in PATHS[kind]} }")
    writer_runs(card, tmp, mtx)
    log(f"{tag} [{card}] {time.time() - t0:.1f}s")


class HostCSC:
    """Counts held in host memory as CSC arrays, behind the in-memory
    block's contract (what ``ShardStore.build`` and ``DeviceCSC`` read)."""

    def __init__(self, data: torch.Tensor, B: int):
        cells, genes = torch.nonzero(data, as_tuple=True)
        self.vals = data[cells, genes].float().cpu().numpy()
        self.rows = genes.int().cpu().numpy()
        counts = torch.bincount(cells, minlength=data.shape[0])
        self.indptr = np.concatenate([[0], counts.cumsum(0).cpu().numpy()])
        self.N, self.D, self.B = data.shape[0], data.shape[1], B
        self.val_dtype = np.dtype({torch.int8: np.int8,
                                   torch.int16: np.int16}[data.dtype])

    def csc_arrays(self):
        return self.rows, self.vals, self.indptr

    def k_max(self) -> int:
        return int(np.diff(self.indptr).max())

    def nfeature(self) -> int:
        return self.D

    def ntot(self) -> int:
        return self.N

    def size(self) -> int:
        return self.B


def locked_store_copy(store):
    """The design the staging ring stands in for: the rotating shards
    page-locked whole (``pin_memory``: page-locked host memory and one
    host copy, once), then one epoch's copies of them from there on a
    side stream.  Returns (bytes, page-lock ms, copy stream ms)."""
    rot = [r for r in range(store.nshards) if r not in store.pinned_idx]
    t0 = time.perf_counter()
    locked = [torch.from_numpy(a).pin_memory() for r in rot
              for a in store.shards[r].arrays]
    lock_ms = (time.perf_counter() - t0) * 1e3
    s = torch.cuda.Stream()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    with torch.cuda.stream(s):
        a.record(s)
        outs = [t.to(DEV, non_blocking=True) for t in locked]
        b.record(s)
    b.synchronize()
    del outs
    return sum(t.numel() * t.element_size() for t in locked), lock_ms, \
        a.elapsed_time(b)


def phase_rotating_full(card, data, ref):
    """Phase 36: phase 9's training (NB packed step, the same seed and
    initialization) over the same 40,000 cells on the rotating tier: the
    counts copied to a host CSC, 8 shards in the layout the store picks,
    4 of them resident, 2 epochs; reports and parameters equal phase 9's
    bitwise.  Prints epoch-2 cells/sec beside phase 9's, the device idle
    share (profile of a 20-batch store of 4 shards, 2 rotating), the bytes
    copied an epoch, the copy stream's busy time and whether compute
    waited on a copy; then the ELL-resident tier on the same cells."""
    from mmvae_tpu_torch.data.shards import ShardStore
    from mmvae_tpu_torch.ops.densify import DeviceCSC
    from mmvae_tpu_torch.ops.nb_fast import tree_leaves
    from mmvae_tpu_torch.train.config import TrainingOptions
    from mmvae_tpu_torch.train.loop import (DenseEpochRunner, EllBatches,
                                            RotatingBatches)

    tag = "[phase 36]"
    t0 = time.time()
    host = HostCSC(data[:N_EARLIER], B_TRAIN)
    nnz = len(host.rows)
    whole = ShardStore.build(host, B_TRAIN, shard_budget=1 << 62)
    per_batch = whole.shard_bytes(0) / whole.nbatch
    # 8 shards of nbatch / 8 batches, 4 kept resident
    budget = int(per_batch * (whole.nbatch // 8))
    store = ShardStore.build(host, B_TRAIN, shard_budget=budget,
                             pin_budget=4 * budget, device=DEV)
    del whole
    setup = time.time() - t0
    if store.nshards < 8 or len(store.pinned_idx) != store.nshards // 2:
        raise AssertionError(f"store plan: {store.nshards} shards, "
                             f"{len(store.pinned_idx)} resident")
    model, step_cls = model_and_step("nb")

    def train(source):
        fast = step_cls(model, TrainingOptions())
        params = model.init(torch.Generator().manual_seed(SEED), device=DEV)
        runner = DenseEpochRunner(fast, source, B_TRAIN, seed=SEED,
                                  superbatch=None)
        q = fast.pack(params)
        po = fast.optimizer.init(q)
        reps, times, copies = [], [], []
        for epoch in range(2):
            if getattr(source, "store", None) is not None \
                    and source.store.stager is not None:
                source.store.stager.reset_stats()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            q, po, r, _ = runner(q, po, epoch)
            r.double().mean().item()
            times.append(time.perf_counter() - t1)
            reps.append(r)
            if getattr(source, "store", None) is not None:
                copies.append(source.store.stager.stats())
        return fast, q, reps, times, copies

    reset_launches()
    fast, q, reps, times, copies = train(RotatingBatches(store))
    launches = read_launches()
    if any(launches[k] < 1 for k in NB_PATH):
        raise AssertionError(f"rotating run launches {launches}")
    same = all(torch.equal(a, b) for a, b in zip(reps, ref["reps"]))
    got, want = fast.unpack(q), ref["params"]
    same_p = leaf_names(got) == leaf_names(want) and all(
        torch.equal(a, b) for a, b in zip(tree_leaves(got),
                                          tree_leaves(want)))
    if not (same and same_p):
        raise AssertionError(f"rotating tier vs phase 9: reports equal "
                             f"{same}, parameters equal {same_p}")
    N = N_EARLIER
    rate, c2 = N / times[1], copies[1]
    lk_bytes, lock_ms, lk_copy_ms = locked_store_copy(store)
    # device idle share: a profile of a 20-batch store (4 shards of 5
    # batches, 2 rotating) in steady state, against the full run's wall
    nprof = 20
    sub_host = HostCSC(data[:nprof * B_TRAIN], B_TRAIN)
    sub_store = ShardStore.build(sub_host, B_TRAIN,
                                 shard_budget=int(per_batch * 5),
                                 pin_budget=int(per_batch * 10),
                                 layout=store.layout, device=DEV)
    sub = DenseEpochRunner(fast, RotatingBatches(sub_store), B_TRAIN,
                           seed=SEED, superbatch=None)
    rand = sub.draw(2)
    qs, pos = q, fast.optimizer.init(q)
    sub(qs, pos, 2, rand=rand)  # the resident shards' first copies
    busy, per = device_profile(lambda: sub(qs, pos, 2, rand=rand))
    copy_ms = sum(v for k, v in per.items() if "Memcpy" in k or "memcpy"
                  in k)
    wall_batch = times[1] * 1e3 / store.nbatch
    log(f"{tag} [{card}] rotating tier, {N} x {D_GENES} int8 from a host "
        f"CSC ({nnz:,} nonzeros, built in {setup:.1f}s): {store.layout} "
        f"layout, {store.nshards} shards of ~{store.shard_bytes(0) / 1e6:.2f}"
        f" MB, {len(store.pinned_idx)} resident "
        f"({sorted(store.pinned_idx)}); 2 epochs: reports and parameters "
        f"equal phase 9's bitwise; epoch times {times[0]:.2f}s, "
        f"{times[1]:.2f}s; second epoch {rate:,.1f} cells/sec (phase 9, "
        f"dense-resident, same run: {ref['rate']:,.1f}); epoch 2 copied "
        f"{c2['copies']} shards, {c2['bytes']:,} bytes host to device "
        f"(epoch 1 {copies[0]['copies']} shards, {copies[0]['bytes']:,} "
        f"bytes), host memcpy into the staging ring {c2['host_memcpy_ms']:.3f}"
        f" ms, copy stream busy {c2['copy_stream_ms']:.3f} ms "
        f"({c2['bytes'] / max(c2['copy_stream_ms'], 1e-9) / 1e6:.2f} GB/s); "
        f"compute waited on a copy {c2['compute_waits']} times "
        f"({c2['compute_wait_ms']:.3f} ms; epoch 1 {copies[0]['compute_waits']}"
        f" times, {copies[0]['compute_wait_ms']:.3f} ms); kernel launches a "
        f"batch { {k: launches[k] / (2 * store.nbatch) for k in NB_PATH} }")
    log(f"{tag} [{card}] against page-locking the rotating shards whole "
        f"(no staging ring): {lk_bytes:,} bytes page-locked in "
        f"{lock_ms:.3f} ms once, then an epoch's copies {lk_copy_ms:.3f} ms "
        f"of copy stream ({lk_bytes / max(lk_copy_ms, 1e-9) / 1e6:.2f} "
        f"GB/s) and no host memcpy; the ring: {c2['host_memcpy_ms']:.3f} ms "
        f"host memcpy + {c2['copy_stream_ms']:.3f} ms copy stream an epoch")
    log(f"{tag} [{card}] profile of {nprof} rotating batches (4 shards, 2 "
        f"rotating, steady state): device busy {busy / nprof:.3f} ms per "
        f"batch in {device_profile.kernels / nprof:.0f} device kernels and "
        f"copies (host-to-device copies {copy_ms / nprof:.4f} ms a batch, on "
        f"the copy stream beside compute), against {wall_batch:.3f} ms wall "
        f"per batch of the second epoch (device idle share "
        f"{1 - busy / nprof / wall_batch:.1%})")
    del store, sub_store
    csc = DeviceCSC.from_memory_block(host, count_dtype="auto", device=DEV)
    reset_launches()
    fast, q, reps, times, _ = train(EllBatches(csc, B_TRAIN))
    launches = read_launches()
    if any(launches[k] < 1 for k in NB_PATH) or not all(
            torch.equal(a, b) for a, b in zip(reps, ref["reps"])):
        raise AssertionError(f"ELL tier: reports differ from phase 9's, or "
                             f"launches {launches}")
    ell_mb = sum(t.numel() * t.element_size()
                 for t in (csc.ell_rows, csc.ell_vals)) / 1e6
    log(f"{tag} [{card}] ELL-resident tier on the same cells (ELL "
        f"{ell_mb:,.1f} MB on the card, k_max {csc.k_max}): "
        f"reports equal phase 9's bitwise; epoch times {times[0]:.2f}s, "
        f"{times[1]:.2f}s; second epoch {N / times[1]:,.1f} cells/sec")


# ----------------------------------------------------------------------
# phase 43: the superbatch graphs at full width
# ----------------------------------------------------------------------

SB_S = 8  # JAX's --superbatch default
# batches an epoch: no multiple of SB_S, so every epoch ends with a
# superbatch of 5 (its own graph)
SB_BATCHES = 37
# route -> the kernels its step launches
SB_ROUTES = {"nb": NB_PATH, "generic": GENERIC_PATH, "joint": JOINT_PATH,
             "mixture": MIXTURE_PATH, "vmf": []}


def sb_route(kind):
    """(model, step) of a phase-43 route: the model's packed step at the
    default architecture, or ``nb_vae --no_fused_step``'s generic
    step."""
    from mmvae_tpu_torch.train.config import TrainingOptions

    if kind == "generic":
        model = model_and_step("nb")[0]
        return model, generic_trainer(model,
                                      TrainingOptions(fused_step=False))
    model, step_cls = model_and_step(kind)
    return model, step_cls(model, TrainingOptions())


def sb_epochs(runner, q, po, first, n):
    """Epochs first .. first + n - 1 of ``runner`` (epoch 1 recording):
    [{q, po, reps, enc, wall}] after each."""
    out = []
    for epoch in range(first, first + n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        q, po, reps, enc = runner(q, po, epoch, record=epoch == 1)
        torch.cuda.synchronize()
        out.append(dict(q=q, po=po, reps=reps, enc=enc,
                        wall=time.perf_counter() - t0))
    return out


def tree_diff(a, b) -> float:
    """0.0 when the trees are bitwise equal, else the largest |a - b| (or
    inf for a shape or dtype that differs)."""
    if isinstance(a, dict):
        return max((tree_diff(a[k], b[k]) for k in a), default=0.0)
    if isinstance(a, (tuple, list)):
        return max((tree_diff(x, y) for x, y in zip(a, b)), default=0.0)
    if a is None or b is None:
        return 0.0 if a is b else float("inf")
    if a.shape != b.shape or a.dtype != b.dtype:
        return float("inf")
    if torch.equal(a, b):
        return 0.0
    return max(float((a.double() - b.double()).abs().max()), 1e-300)


def epoch_diffs(got: list, want: list) -> dict:
    """{what: largest difference} of two runs' epochs, nonzero entries."""
    out = {}
    for i, (g, w) in enumerate(zip(got, want)):
        for k in ("q", "po", "reps", "enc"):
            d = tree_diff(g[k], w[k])
            if d:
                out[f"epoch {i} {k}"] = d
    return out


# the first stage of each port kernel: one CUDA function a launch (the
# second, ``*_sum``, may be left out by a launch that needs no merge)
FIRST_STAGE = {"count_encode_tiles", "count_encode_bwd_tiles", "lse_tiles",
               "value_tiles", "valgrad_tiles", "finish_tiles",
               "elbo_fwd_rows", "elbo_bwd_groups"}


def replay_launches(fn, booked: dict, tries: int = 3):
    """({port kernel: launches}, traces) of one call of ``fn`` from the
    profiler (CUPTI, as :func:`device_profile`): each port kernel's
    first-stage CUDA functions, named by ``trace_step.port_kernel``.  A
    trace runs ``fn`` twice, a warm-up step whose events are dropped
    (late in a long process a cold trace lost the first kernel of a
    replay) and the step it reads; its kernels' times are not used (in
    one run they read 2.4-2.9x :func:`device_profile`'s).  A trace whose
    launches differ from ``booked`` is taken again, up to ``tries`` in
    all: a launch the graph lacks, or one it holds beyond ``booked``,
    differs in every trace.  Returns the last trace's."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from mmvae_tpu_torch.benchmarks import trace_step
    from mmvae_tpu_torch.utils.profiling import kernel_times

    for t in range(1, tries + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):
                fn()
                torch.cuda.synchronize()
                prof.step()
        kt = kernel_times(prof)
        seen: dict = {}
        for name, (_, n) in kt.items():
            m = re.search(r"\(anonymous namespace\)::(\w+)[<(]", name)
            if m and m.group(1) in FIRST_STAGE:
                k = trace_step.port_kernel(name)
                seen[k] = seen.get(k, 0) + n
        if seen == booked:
            break
    return seen, t


def phase_superbatch(card, data, tmp):
    """Phase 43: each route of :data:`SB_ROUTES` at full width (B = 100,
    D = 20,000 int8, the first :data:`SB_BATCHES` batches of phase 5's
    counts) for 3 epochs, the second recording, through the S = 8
    superbatch graphs and through the eager per-batch path
    (``superbatch=None``) on the same draws: parameters, Adam state,
    reports and posteriors bitwise equal; the graphs' launches (less
    their warm-ups') equal to the eager run's, every kernel of the route
    counted; the launches the profiler sees in a replay of the S = 8
    graph equal, kernel by kernel, to what the graph books a replay; a
    resume from a checkpoint of epoch 0 through the same graphs equal to
    epochs 1-2 bitwise; the third epoch's cells/sec, wall and
    device-busy ms a batch (one replay of the S = 8 graph, and two eager
    batches, profiled), the idle share, the capture seconds and the
    graphs' pool.  Returns {route: numbers}."""
    from mmvae_tpu_torch.models.nb import adam_from_numpy, params_from_numpy
    from mmvae_tpu_torch.train.checkpoint import (load_checkpoint,
                                                  load_opt_state,
                                                  save_checkpoint)
    from mmvae_tpu_torch.train.loop import DenseEpochRunner

    tag = "[phase 43]"
    d = data[:SB_BATCHES * B_TRAIN]
    cells = d.shape[0]
    out, bad = {}, {}
    names = {n: f"{w.__name__}.{a}" for n, (w, a) in _counters().items()}
    for kind, path in SB_ROUTES.items():
        model, fast = sb_route(kind)
        enc_fn, _ = model.record_encoder(SEED, B_TRAIN)

        def record(p, x, enc_fn=enc_fn):
            with torch.no_grad():
                return enc_fn(p, x)

        params = model.init(torch.Generator().manual_seed(SEED), device=DEV)
        runs, counts, runners = {}, {}, {}
        for how, S in (("eager", None), ("graphs", SB_S)):
            runner = DenseEpochRunner(fast, d, B_TRAIN, seed=SEED,
                                      record_fn=record, superbatch=S)
            q = fast.pack(params)
            reset_launches()
            runs[how] = sb_epochs(runner, q, fast.optimizer.init(q), 0, 3)
            counts[how] = read_launches()
            runners[how] = runner
        sb = runners["graphs"].graphs
        warm = {n: sb.warm_launches.get(k, 0) for n, k in names.items()}
        replayed = {n: counts["graphs"][n] - warm[n] for n in names}
        diffs = epoch_diffs(runs["graphs"], runs["eager"])
        if replayed != counts["eager"] or any(
                counts["eager"][n] <= 0 for n in path) or (
                not path and any(counts["graphs"].values())):
            diffs["launches"] = (f"graphs {replayed} (+ warm-up {warm}), "
                                 f"eager {counts['eager']}")
        # resume from epoch 0's checkpoint through the same graphs
        ck = os.path.join(tmp, f"sb_{kind}")
        e0 = runs["graphs"][0]
        save_checkpoint(ck, fast.unpack(e0["q"]), 0, SEED,
                        [float(e0["reps"].double().mean())],
                        opt_state=fast.unpack_opt_state(e0["po"]))
        p_np, start, _ = load_checkpoint(ck, model)
        q = fast.pack(params_from_numpy(p_np, DEV))
        po = fast.pack_opt_state(adam_from_numpy(load_opt_state(ck, model),
                                                 DEV))
        resumed = sb_epochs(runners["graphs"], q, po, start, 2)
        for k, v in epoch_diffs(resumed, runs["graphs"][1:]).items():
            diffs[f"resume {k}"] = v
        # device busy: one replay of the S-batch graph, two eager batches;
        # the replay's launches as the profiler sees them against those
        # the graph books (its capture's counts)
        booked: dict = {}
        for n, k in names.items():
            v = sb.graphs[(SB_S, False)][1].get(k, 0)
            if v:
                base = n.split("[")[0]
                booked[base] = booked.get(base, 0) + v
        seen, traces = replay_launches(lambda: sb.run(SB_S, False), booked)
        g_busy, _ = device_profile(lambda: sb.run(SB_S, False))
        g_ops = device_profile.kernels / SB_S
        if seen != booked or any(
                booked.get(n.split("[")[0], 0) <= 0 for n in path):
            diffs["replay launches"] = (f"profiled {seen}, booked "
                                        f"{booked}")
        sub = DenseEpochRunner(fast, d[:2 * B_TRAIN], B_TRAIN, seed=SEED,
                               superbatch=None)
        rand = sub.draw(3)
        qe, poe = runs["eager"][-1]["q"], runs["eager"][-1]["po"]
        e_busy, _ = device_profile(lambda: sub(qe, poe, 3, rand=rand))
        e_ops = device_profile.kernels / 2
        st = runners["graphs"].graph_stats
        r = {"S": SB_S, "batches": SB_BATCHES,
             "captures": st["captures"], "capture_s": st["capture_s"],
             "pool_mb": st["pool_bytes"] / 1e6}
        for how, busy, ops, n in (("eager", e_busy, e_ops, 2),
                                  ("graphs", g_busy, g_ops, SB_S)):
            wall = runs[how][2]["wall"]
            r[how] = {"cells_per_sec": cells / wall,
                      "wall_ms": wall * 1e3 / SB_BATCHES,
                      "busy_ms": busy / n, "ops": ops,
                      "idle": 1 - busy / n / (wall * 1e3 / SB_BATCHES)}
        out[kind] = r
        runners["graphs"].close()
        if diffs:
            bad[kind] = diffs
        e, g = r["eager"], r["graphs"]
        log(f"{tag} [{card}] {kind}: {cells} x {D_GENES} int8, B="
            f"{B_TRAIN}, nboot 3, S = {SB_S} ({SB_BATCHES} batches an "
            f"epoch: superbatches of 8 and 5), 3 epochs (the second "
            f"recording) and a resume from epoch 0: "
            + ("graphs == eager bitwise (parameters, Adam state, reports, "
               "posteriors, resume); " if not diffs else
               f"DIFFERS {diffs}; ")
            + f"launches replayed {dict((n, replayed[n]) for n in path)} "
            f"== eager (+ warm-up {dict((n, warm[n]) for n in path)}); "
            f"a replay of the {SB_S}-batch graph profiled: launches {seen} "
            f"(booked {booked}; trace {traces}); "
            f"third epoch: graphs {g['cells_per_sec']:,.1f} cells/sec, "
            f"{g['wall_ms']:.3f} ms wall a batch, {g['busy_ms']:.3f} ms "
            f"device busy, {g['ops']:.0f} device ops a batch, idle "
            f"{g['idle']:.1%}; eager {e['cells_per_sec']:,.1f} cells/sec, "
            f"{e['wall_ms']:.3f} ms wall, {e['busy_ms']:.3f} ms busy, "
            f"{e['ops']:.0f} ops, idle {e['idle']:.1%} "
            f"({g['cells_per_sec'] / e['cells_per_sec']:.2f}x); "
            f"{r['captures']} graphs captured in {r['capture_s']:.2f}s "
            f"(warm-ups included), pool {r['pool_mb']:,.1f} MB")
    if bad:
        raise AssertionError(f"superbatch graphs against eager: {bad}")
    return out


# ----------------------------------------------------------------------
# data-parallel phases (37-38): each rank a process of this script
# (``--dp-worker``), both ranks on their own card, or sharing the one
# ----------------------------------------------------------------------

# phase 37's --data_parallel run against phase 42's unclustered
# single-process run (a mesh never clusters): the packed step's
# trajectory yardstick (tests/test_torch_train.py), the ranks' kernels
# seeing 50 rows where the single process saw 100 (a 64-column tile's
# lgamma regime is chosen over the rows a launch sees)
DP_TOL = ("scores |dp - single| <= 2e-4 |single|; every artifact "
          "|dp - single| <= 3e-3 |single| + 2e-5 max|single|")


def dp_runs(tmp: str, mtx: str) -> list[dict]:
    """Phase 37's CLI runs, in order, each in its own directory: per mode
    two 2-epoch runs, a 1-epoch run and its resume to epoch 2; then one
    epoch of each other trainer under --dp_shard.  Rank 1 is given a
    checkpoint directory of its own, which must stay unmade."""
    annot, row = write_annotation(tmp, marker_label())
    runs = []

    def run(name, cli, epochs, *extra, path=NB_PATH):
        d = os.path.join(tmp, "dp", name)
        os.makedirs(d)
        label = " ".join([cli, *(a for a in extra if a.startswith("--")
                                 and a not in ("--row", "--resume"))])
        runs.append(dict(
            name=name, cli=cli, path=path, dir=d, label=label,
            args=["--mtx", mtx, "--batch_size", str(B_TRAIN), "--device",
                  DEV, "--recording", "2", "--out", os.path.join(d, "run"),
                  "--max_epoch", str(epochs), "--checkpoint_dir",
                  os.path.join(d, "ck"), *extra],
            rank1_args=["--checkpoint_dir", os.path.join(d, "ck_rank1")]))

    for mode in ("data_parallel", "dp_shard"):
        for name, epochs in (("a", 2), ("b", 2), ("r1", 1)):
            run(f"{mode}_{name}", "nb_vae", epochs, f"--{mode}")
        run(f"{mode}_r", "nb_vae", 2, f"--{mode}", "--resume",
            os.path.join(tmp, "dp", f"{mode}_r1", "ck"))
    run("joint", "vmfnb_vae", 1, "--dp_shard", path=JOINT_PATH)
    run("mixture", "vmfnb_vae", 1, "--dp_shard", "--annot", annot, "--row",
        row, path=MIXTURE_PATH)
    run("vmf", "vmf_vae", 1, "--dp_shard", path=[])
    run("generic", "nb_vae", 1, "--dp_shard", "--mean_decoding", "16",
        path=GENERIC_PATH)
    return runs


def dp_full(rank: int, shapes: dict) -> dict:
    """Phase 38 on one rank: the NB packed step under --dp_shard over this
    rank's rows of phase 9's cells (phase 5's counts, made on the card
    from the seed), phase 9's seed and initialization, 2 epochs; then
    20 batches with the device synchronised around each collective (the
    all-reduce's own time), and 20 profiled.  Every rank calls the same
    collectives in the same order, so nothing here retries on one rank
    alone."""
    from torch.profiler import ProfilerActivity, profile

    from mmvae_tpu_torch.parallel.mesh import DataMesh
    from mmvae_tpu_torch.parallel.multihost import barrier
    from mmvae_tpu_torch.train.config import TrainingOptions
    from mmvae_tpu_torch.train.loop import DenseEpochRunner
    from mmvae_tpu_torch.utils.profiling import kernel_times

    data = full_size_counts()
    local = data[:N_EARLIER].view(-1, DP_WORLD, DP_M, D_GENES)[:, rank]
    local = local.reshape(-1, D_GENES).contiguous()
    del data
    torch.cuda.empty_cache()
    model, step_cls = model_and_step("nb")
    fast = step_cls(model, TrainingOptions())
    params = model.init(torch.Generator().manual_seed(SEED), device=DEV)
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = DataMesh(DP_WORLD, rank, dev, "dp_shard")
    runner = DenseEpochRunner(fast, local, B_TRAIN, seed=SEED, mesh=mesh)
    q = fast.pack(params)
    po = fast.optimizer.init(q)
    reset_launches()
    shapes.clear()
    times, losses = [], []
    for epoch in range(2):
        torch.cuda.synchronize()
        barrier()
        t0 = time.perf_counter()
        q, po, reps, _ = runner(q, po, epoch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(reps.double().mean().item())
    launches = {k: n / (2 * runner.nbatch)
                for k, n in read_launches().items() if n}
    nprof = 20
    sub = DenseEpochRunner(fast, local[:nprof * DP_M], B_TRAIN, seed=SEED,
                           mesh=mesh)
    rand = sub.draw(2)
    # the step's all-reduces, timed with the device synchronised before
    # each clock starts (so leaving out the kernels that make the buffer)
    # and after it stops
    ar = {"calls": 0, "bytes": 0, "seconds": 0.0}
    real = torch.distributed.all_reduce

    def timed(t, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(t, *a, **kw)
        torch.cuda.synchronize()
        ar["seconds"] += time.perf_counter() - t0
        ar["calls"] += 1
        ar["bytes"] += t.numel() * t.element_size()
        return out

    barrier()
    torch.distributed.all_reduce = timed
    try:
        sub(q, po, 2, rand=rand)
    finally:
        torch.distributed.all_reduce = real
    torch.cuda.synchronize()
    barrier()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sub(q, po, 2, rand=rand)
        torch.cuda.synchronize()
    kt = kernel_times(prof)
    # NCCL's kernels run from the collective's launch until the peer
    # arrives: their time is mostly waiting, so it stays out of busy
    comm = sum(us for k, (us, _) in kt.items()
               if "nccl" in k.lower()) / 1e3 / nprof
    busy = sum(us for us, _ in kt.values()) / 1e3 / nprof - comm
    copies = sum(us for k, (us, _) in kt.items()
                 if "memcpy" in k.lower()) / 1e3 / nprof
    per_batch = times[1] * 1e3 / runner.nbatch
    return dict(
        rate=local.shape[0] / times[1], times=times, losses=losses,
        launches=launches,
        shapes={k: sorted(v) for k, v in shapes.items()},
        allreduce_ms=ar["seconds"] * 1e3 / nprof,
        allreduce_calls=ar["calls"] / nprof,
        allreduce_bytes=ar["bytes"] / max(1, ar["calls"]),
        busy_ms=busy, copy_ms=copies, comm_ms=comm, per_batch_ms=per_batch,
        idle=1 - busy / per_batch if busy else None,
        q_sha=hashlib.sha256(b"".join(
            q[k].cpu().numpy().tobytes() for k in sorted(q))).hexdigest())


def dp_worker(rank: int, plan_path: str) -> int:
    """One rank of phases 37-38 (``python3 chip_smoke.py --dp-worker RANK
    PLAN``): join the process group, run each planned CLI with every
    launch counter and the launches' shapes reset just before and read
    just after, keep each run's final parameters, then phase 38; writes
    ``rank<RANK>.json`` beside the plan."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from mmvae_tpu_torch.cli import common, nb_vae, vmf_vae, vmfnb_vae
    from mmvae_tpu_torch.parallel.multihost import init_multihost
    from mmvae_tpu_torch.train.recorder import flatten_params

    with open(plan_path) as f:
        plan = json.load(f)
    init_multihost(plan["coordinator"], DP_WORLD, rank, torch.device(DEV))
    clis = {"nb_vae": nb_vae, "vmf_vae": vmf_vae, "vmfnb_vae": vmfnb_vae}
    final = {}
    real = common.train_vae_model

    def keep_final(*a, **kw):
        final["params"], scores = real(*a, **kw)
        return final["params"], scores

    common.train_vae_model = keep_final
    out, shapes = {"runs": {}}, {}
    with launch_shapes(shapes):
        for run in plan["runs"]:
            argv = run["args"] + [
                "--num_hosts", str(DP_WORLD), "--host_id", str(rank),
                "--coordinator", plan["coordinator"]]
            if rank:
                argv += run["rank1_args"]
            reset_launches()
            shapes.clear()
            t0 = time.time()
            tee = _Tee(sys.stderr)
            with contextlib.redirect_stderr(tee):
                rc = clis[run["cli"]].main(argv)
            if rc != 0:
                raise AssertionError(f"rank {rank}: {run['name']} failed")
            err = tee.buf.getvalue()
            out["runs"][run["name"]] = dict(
                launches=read_launches(), wall=time.time() - t0,
                shapes={k: sorted(v) for k, v in shapes.items()},
                tier=("dense-resident DP layout"
                      if "dense-resident, DP layout" in err else "host path"),
                resumed="Resumed from" in err)
            np.savez(os.path.join(run["dir"], f"final_rank{rank}.npz"),
                     **flatten_params(final["params"]))
        out["full"] = dp_full(rank, shapes)
    with open(os.path.join(os.path.dirname(plan_path),
                           f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    torch.distributed.destroy_process_group()
    return 0


def dp_outputs(d: str) -> dict:
    """A run's files: ``run*.gz`` decompressed (the gzip header holds the
    file's name), the checkpoint's arrays."""
    got = {}
    for f in sorted(os.listdir(d)):
        if f.startswith("run") and f.endswith(".gz"):
            with gzip.open(os.path.join(d, f)) as fh:
                got[f] = fh.read()
    with np.load(os.path.join(d, "ck", "ckpt.npz")) as z:
        got.update({f"ck/{k}": z[k] for k in z.files})
    return got


def dp_vs_single(d: str, single: str) -> tuple[float, float]:
    """(largest |dp - single| / |single| of the scores, largest err/tol of
    the artifacts under :data:`DP_TOL`) of a run against phase 42's
    unclustered single-process one."""
    s_dp = np.loadtxt(os.path.join(d, "run.scores.gz"), ndmin=1)
    s_1 = np.loadtxt(single + ".scores.gz", ndmin=1)
    worst = 0.0
    for f in os.listdir(d):
        if f.startswith("run_") and f.endswith(".gz"):
            a = np.loadtxt(os.path.join(d, f), ndmin=1)
            w = np.loadtxt(single + f[3:], ndmin=1)
            if a.shape != w.shape:
                raise AssertionError(f"{f}: shape {a.shape} vs {w.shape}")
            tol = 3e-3 * np.abs(w) + 2e-5 * np.abs(w).max()
            worst = max(worst, float(np.max(np.abs(a - w) / tol)))
    return float(np.max(np.abs(s_dp - s_1) / np.abs(s_1))), worst


def check_dp_shapes(what: str, shapes: dict) -> None:
    """Every launch of a rank's run (``{C entry: shapes}``) at DP_M rows
    and at a shape that phases 2-30 held against plain (:data:`HELD`)."""
    bad = {k: [s for s in v if s[0] != DP_M or tuple(s) not in HELD.get(k, ())]
           for k, v in shapes.items()}
    bad = {k: v for k, v in bad.items() if v}
    if bad:
        raise AssertionError(
            f"{what}: launches not at {DP_M} rows or at a shape no phase "
            f"held against plain ({SHAPE_ARGS} gives the arguments): {bad}; "
            f"held: { {k: sorted(v) for k, v in HELD.items()} }")


def phase_dp(card, tmp, mtx, rate9):
    """Phases 37-38: two ranks (NCCL on two cards when there are two,
    gloo with both on the one card otherwise), each a process of this
    script with its own timeout."""
    runs = dp_runs(tmp, mtx)
    plan = os.path.join(tmp, "dp", "plan.json")
    with open(plan, "w") as f:
        json.dump({"coordinator": f"127.0.0.1:{free_port()}", "runs": runs},
                  f)
    env = dict(os.environ, MMVAE_DIST_TIMEOUT="120")
    logs = [open(os.path.join(tmp, "dp", f"rank{r}.log"), "w+")
            for r in range(DP_WORLD)]
    t0 = time.time()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--dp-worker", str(r), plan], env=env,
                              stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(DP_WORLD)]
    try:
        for p in procs:
            p.wait(timeout=480)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    texts = []
    for f in logs:
        f.seek(0)
        texts.append(f.read())
        f.close()
    if any(p.returncode != 0 for p in procs):
        raise AssertionError("a rank failed:\n" + "\n---\n".join(
            t[-4000:] for t in texts))
    res = []
    for r in range(DP_WORLD):
        with open(os.path.join(tmp, "dp", f"rank{r}.json")) as f:
            res.append(json.load(f))
    backend = re.search(r"backend (\w+) \(([^;]*);", texts[0])
    log(f"[phase 37] [{card}] {DP_WORLD} ranks, backend {backend.group(1)} "
        f"({backend.group(2)}; {torch.cuda.device_count()} device(s)); "
        f"ranks ran {time.time() - t0:.1f}s")
    single = os.path.join(tmp, "train_flat")  # phase 42's, unclustered
    for run in runs:
        name, d = run["name"], run["dir"]
        per_rank = [x["runs"][name] for x in res]
        for r, got in enumerate(per_rank):
            lau = got["launches"]
            if (min(lau[k] for k in run["path"]) < 1 if run["path"]
                    else any(lau.values())):
                raise AssertionError(f"{name} rank {r}: launches {lau}")
            check_dp_shapes(f"{name} rank {r}", got["shapes"])
        finals = [dict(np.load(os.path.join(d, f"final_rank{r}.npz")))
                  for r in range(DP_WORLD)]
        if not all(np.array_equal(finals[0][k], x[k]) for x in finals[1:]
                   for k in finals[0]):
            raise AssertionError(f"{name}: the ranks' parameters differ")
        if os.path.exists(os.path.join(d, "ck_rank1")):
            raise AssertionError(f"{name}: rank 1 wrote a checkpoint")
        scores = np.loadtxt(os.path.join(d, "run.scores.gz"), ndmin=1)
        if not np.isfinite(scores).all():
            raise AssertionError(f"{name}: scores {scores}")
        extra = ""
        if name == "data_parallel_a":
            e_s, e_a = dp_vs_single(d, single)
            if not (e_s <= 2e-4 and e_a <= 1.0):
                raise AssertionError(f"--data_parallel vs one process: scores "
                                     f"{e_s:.3g}, artifacts err/tol {e_a:.3g}")
            extra = (f"; against phase 42's unclustered single-process "
                     f"run: scores rel "
                     f"{e_s:.3g}, artifacts err/tol {e_a:.3g} ({DP_TOL})")
        for mode in ("data_parallel", "dp_shard"):
            if name in (f"{mode}_b", f"{mode}_r"):
                want = dp_outputs(os.path.join(tmp, "dp", f"{mode}_a"))
                got = dp_outputs(d)
                if not same_outputs(got, want):
                    raise AssertionError(f"{name} differs from {mode}_a")
                extra = (f"; equals {mode}_a bitwise ({len(want)} files and "
                         f"arrays)")
        tier = per_rank[0]["tier"]
        if tier != ("host path" if name.startswith("data_parallel")
                    else "dense-resident DP layout"):
            raise AssertionError(f"{name}: {tier}, not JAX's tier")
        if name.endswith("_r") and not per_rank[0]["resumed"]:
            raise AssertionError(f"{name} did not resume")
        log(f"[phase 37] [{card}] {name} ({run['label']}, {tier}): scores "
            f"{scores.tolist()}; launches rank 0 "
            f"{ {k: per_rank[0]['launches'][k] for k in run['path']} }, "
            f"rank 1 { {k: per_rank[1]['launches'][k] for k in run['path']} }"
            f", every launch at {DP_M} rows and at one of "
            f"{sum(map(len, per_rank[0]['shapes'].values()))} shapes (rank 0) "
            f"held against plain in phases 2-30; ranks' final parameters "
            f"bitwise equal; rank 0 alone wrote; wall "
            f"{per_rank[0]['wall']:.2f}s{extra}")
    full = [x["full"] for x in res]
    for r, fr in enumerate(full):
        if not (np.isfinite(fr["losses"]).all()
                and fr["losses"][1] < fr["losses"][0]):
            raise AssertionError(f"phase 38 rank {r}: losses {fr['losses']}")
        if any(fr["launches"].get(k, 0) <= 0 for k in NB_PATH):
            raise AssertionError(f"phase 38 rank {r}: {fr['launches']}")
        check_dp_shapes(f"phase 38 rank {r}", fr["shapes"])
    if full[0]["q_sha"] != full[1]["q_sha"]:
        raise AssertionError("phase 38: the ranks' parameters differ")
    total = sum(fr["rate"] for fr in full)
    log(f"[phase 38] [{card}] NB packed step --dp_shard, {DP_WORLD} ranks "
        f"({backend.group(1)}) x {DP_M} rows of every batch of {B_TRAIN}, "
        f"{N_EARLIER} x {D_GENES} int8, 2 epochs: epoch losses "
        f"{full[0]['losses'][0]:.4f} -> {full[0]['losses'][1]:.4f}; second "
        f"epoch {total:,.1f} cells/sec summed over the ranks ("
        + ", ".join(f"rank {r} {fr['rate']:,.1f}" for r, fr in
                    enumerate(full))
        + f") against phase 9's {rate9:,.1f} on one process "
        f"({total / rate9:.2f}x); launches a batch {full[0]['launches']}")
    for r, fr in enumerate(full):
        log(f"[phase 38] [{card}] rank {r}: {fr['per_batch_ms']:.3f} ms wall "
            f"a batch (second epoch); profile of 20 batches: device busy "
            f"{fr['busy_ms']:.3f} ms a batch, of it copies "
            f"{fr['copy_ms']:.3f} ms"
            + (f", beside NCCL's kernels {fr['comm_ms']:.3f} ms (most of it "
               f"waiting for the peer)" if fr["comm_ms"] else "")
            + " (device idle share "
            + (f"{fr['idle']:.1%}" if fr["idle"] is not None else
               "not measured: the trace holds no device events")
            + f"); gradient all-reduce {fr['allreduce_ms']:.3f} ms a batch "
            f"in {fr['allreduce_calls']:g} collectives of "
            f"{fr['allreduce_bytes'] / 1e6:.2f} MB (host clock, device "
            f"synchronised around each)")
    return total


# ----------------------------------------------------------------------
# tensor-parallel phases (39-41): each rank a process of this script
# (``--tp-worker``), as in phases 37-38
# ----------------------------------------------------------------------

TP_WORLD = 2  # the ranks of phases 39-41: one model row of TP_N
TP_N = 2      # --tensor_parallel
D_TP = D_GENES // TP_N  # the features of every rank's shard
# the kernels of each TP path: the encoders are plain PyTorch (JAX's TP
# encoders are plain products too), so K4, K4s, K4f and K5 stay at 0
TP_PATHS = {"nb": ["nb_lse", "nb_value", "nb_valgrad", "nb_finish"],
            "joint": ["nb_lse", "nb_value[pb,nu_exp]",
                      "nb_valgrad[pb,nu_exp]", "nb_finish"],
            "vmf": []}
TP_PATHS["mixture"] = TP_PATHS["joint"]
TP_CLI = {"nb": "nb_vae", "joint": "vmfnb_vae", "mixture": "vmfnb_vae",
          "vmf": "vmf_vae"}
# phase 39 against one process of the generic Trainer, "single" (the
# ranks' kernels and sums see D / 2 columns where it sees D): PR 15's
# DP_TOL for the scores; Adam's first moments as the CPU tests hold them
# (tests/test_torch_tp_train.py); the parameters by DP_TOL's form where
# the moment is at least 2% of its leaf's largest (Adam's first steps map
# each gradient element to about +-lr by its sign), plus twice the
# largest gap on the leaf between the single process's two routes, the
# generic Trainer and the packed step on the same draws: the float32
# floor of the same math summed in another order.  The joint and mixture
# models' ln_kappa head needs it: its gradient is a sum that cancels
# (ROADMAP Queue 3), and phase 23 holds it to a float64 step
TP_TOL = ("scores |tp - single| <= 2e-4 |single|; Adam's first moments "
          "|tp - single| <= 3e-3 |single| + 1e-3 max|single| over the "
          "leaf's module; parameters |tp - single| <= 3e-3 |single| + "
          "2e-5 max|single| + 2 max|packed - single| over the leaf, where "
          "the moment is >= 2% of its leaf's largest")


def tp_runs(tmp: str, mtx: str) -> list[dict]:
    """Phase 39's CLI runs, in order, each in its own directory: nb_vae
    for 2 epochs, and for 1 epoch resumed to 2; vmfnb_vae, vmfnb_vae
    --annot --row and vmf_vae for 1 epoch; then phase 40's encodes of the
    four checkpoints.  Rank 1 is given a checkpoint directory of its
    own, which must stay unmade."""
    annot, row = write_annotation(tmp, marker_label())
    runs = []

    def run(name, kind, epochs, *extra):
        d = os.path.join(tmp, "tp", name)
        os.makedirs(d)
        runs.append(dict(
            name=name, kind=kind, cli=TP_CLI[kind], dir=d, epochs=epochs,
            args=["--mtx", mtx, "--batch_size", str(B_TRAIN), "--device",
                  DEV, "--recording", "2", "--out", os.path.join(d, "run"),
                  "--max_epoch", str(epochs), "--checkpoint_dir",
                  os.path.join(d, "ck"), "--tensor_parallel", str(TP_N),
                  *extra],
            rank1_args=["--checkpoint_dir", os.path.join(d, "ck_rank1")]))

    run("nb", "nb", 2)
    run("nb_r1", "nb", 1)
    run("nb_r", "nb", 2, "--resume", os.path.join(tmp, "tp", "nb_r1", "ck"))
    run("joint", "joint", 1)
    run("mixture", "mixture", 1, "--annot", annot, "--row", row)
    run("vmf", "vmf", 1)
    for kind, model in (("nb", "nb"), ("joint", "vmfnb"),
                        ("mixture", "mixture"), ("vmf", "vmf")):
        d = os.path.join(tmp, "tp", f"enc_{kind}")
        os.makedirs(d)
        runs.append(dict(
            name=f"enc_{kind}", kind=kind, cli="encode", dir=d,
            args=["--model", model, "--mtx", mtx, "--checkpoint",
                  os.path.join(tmp, "tp", kind, "ck"), "--out",
                  os.path.join(d, "enc"), "--batch_size", str(B_TRAIN),
                  "--device", DEV, "--annot", annot, "--row", row,
                  "--tensor_parallel", str(TP_N)],
            rank1_args=[]))
    return runs


def tp_full(rank: int, shapes: dict) -> dict:
    """Phase 41 on one rank: phase 9's NB model (phase 9's seed and
    initialization, this rank's shard of it) on the first 10,000 of
    phase 9's cells (phase 5's counts made on the card from the seed,
    this rank's D / 2 features kept), the TP ``Trainer`` of ``nb_vae
    --tensor_parallel 2``, 2 epochs; then 20 batches with the device
    synchronised around each collective, and 20 profiled.  Every rank
    calls the same collectives in the same order, so nothing here
    retries on one rank alone."""
    from torch.profiler import ProfilerActivity, profile

    from mmvae_tpu_torch.cli import nb_vae
    from mmvae_tpu_torch.ops.nb_fast import tree_leaves
    from mmvae_tpu_torch.parallel.mesh import (gather_params, make_mesh,
                                               shard_params)
    from mmvae_tpu_torch.parallel.multihost import barrier
    from mmvae_tpu_torch.train.config import TrainingOptions
    from mmvae_tpu_torch.train.loop import DenseEpochRunner
    from mmvae_tpu_torch.utils.profiling import kernel_times

    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = make_mesh(dev, "dp_shard", TP_N)
    data = full_size_counts()
    local = data[:N_SHORT, mesh.local_cols(D_GENES)].contiguous()
    del data
    torch.cuda.empty_cache()
    model, _ = model_and_step("nb")
    fast, _ = nb_vae.make_step(model, TrainingOptions(), mesh=mesh)
    params = shard_params(
        model.init(torch.Generator().manual_seed(SEED), device=DEV),
        fast.tp_pspecs, mesh)
    runner = DenseEpochRunner(fast, local, B_TRAIN, seed=SEED, mesh=mesh)
    q, po = params, fast.optimizer.init(params)
    reset_launches()
    shapes.clear()
    times, losses = [], []
    for epoch in range(2):
        torch.cuda.synchronize()
        barrier()
        t0 = time.perf_counter()
        q, po, reps, _ = runner(q, po, epoch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(reps.double().mean().item())
    launches = {k: n / (2 * runner.nbatch)
                for k, n in read_launches().items() if n}
    nprof = 20
    sub = DenseEpochRunner(fast, local[:nprof * B_TRAIN], B_TRAIN,
                           seed=SEED, mesh=mesh)
    rand = sub.draw(2)
    # the step's all-reduces, timed with the device synchronised before
    # each clock starts (so leaving out the kernels that make the buffer)
    # and after it stops
    ar = {"calls": 0, "bytes": 0, "seconds": 0.0}
    real = torch.distributed.all_reduce

    def timed(t, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(t, *a, **kw)
        torch.cuda.synchronize()
        ar["seconds"] += time.perf_counter() - t0
        ar["calls"] += 1
        ar["bytes"] += t.numel() * t.element_size()
        return out

    barrier()
    torch.distributed.all_reduce = timed
    try:
        sub(q, po, 2, rand=rand)
    finally:
        torch.distributed.all_reduce = real
    torch.cuda.synchronize()
    barrier()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sub(q, po, 2, rand=rand)
        torch.cuda.synchronize()
    kt = kernel_times(prof)
    comm = sum(us for k, (us, _) in kt.items()
               if "nccl" in k.lower()) / 1e3 / nprof
    busy = sum(us for us, _ in kt.values()) / 1e3 / nprof - comm
    copies = sum(us for k, (us, _) in kt.items()
                 if "memcpy" in k.lower()) / 1e3 / nprof
    per_batch = times[1] * 1e3 / runner.nbatch
    full = gather_params(q, fast.tp_pspecs, mesh)
    return dict(
        rate=local.shape[0] / times[1], times=times, losses=losses,
        launches=launches, shapes={k: sorted(v) for k, v in shapes.items()},
        allreduce_ms=ar["seconds"] * 1e3 / nprof,
        allreduce_calls=ar["calls"] / nprof,
        allreduce_bytes=ar["bytes"] / max(1, ar["calls"]),
        busy_ms=busy, copy_ms=copies, comm_ms=comm, per_batch_ms=per_batch,
        idle=1 - busy / per_batch if busy else None,
        q_sha=hashlib.sha256(b"".join(
            v.cpu().numpy().tobytes() for v in tree_leaves(full)))
        .hexdigest())


def tp_worker(rank: int, plan_path: str) -> int:
    """One rank of phases 39-41 (``python3 chip_smoke.py --tp-worker RANK
    PLAN``): join the process group, run each planned CLI with every
    launch counter and the launches' shapes reset just before and read
    just after, keep each training run's final (gathered) parameters,
    then phase 41; writes ``rank<RANK>.json`` beside the plan."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from mmvae_tpu_torch.cli import common, encode, nb_vae, vmf_vae, vmfnb_vae
    from mmvae_tpu_torch.parallel.multihost import init_multihost
    from mmvae_tpu_torch.train.recorder import flatten_params

    with open(plan_path) as f:
        plan = json.load(f)
    init_multihost(plan["coordinator"], TP_WORLD, rank, torch.device(DEV))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    clis = {"nb_vae": nb_vae, "vmf_vae": vmf_vae, "vmfnb_vae": vmfnb_vae,
            "encode": encode}
    final = {}
    real = common.train_vae_model

    def keep_final(*a, **kw):
        final["params"], scores = real(*a, **kw)
        return final["params"], scores

    common.train_vae_model = keep_final
    out, shapes = {"runs": {}}, {}
    with launch_shapes(shapes):
        for run in plan["runs"]:
            argv = run["args"] + [
                "--num_hosts", str(TP_WORLD), "--host_id", str(rank),
                "--coordinator", plan["coordinator"]]
            if rank:
                argv += run["rank1_args"]
            final.clear()
            reset_launches()
            shapes.clear()
            t0 = time.time()
            tee = _Tee(sys.stderr)
            with contextlib.redirect_stderr(tee):
                rc = clis[run["cli"]].main(argv)
            if rc != 0:
                raise AssertionError(f"rank {rank}: {run['name']} failed")
            err = tee.buf.getvalue()
            out["runs"][run["name"]] = dict(
                launches=read_launches(), wall=time.time() - t0,
                shapes={k: sorted(v) for k, v in shapes.items()},
                tier=("dense-resident TP layout" if "TP layout" in err
                      else "TP serving" if "TP serving over" in err
                      else "host path"),
                resumed="Resumed from" in err)
            if final:
                np.savez(os.path.join(run["dir"], f"final_rank{rank}.npz"),
                         **flatten_params(final["params"]))
        out["full"] = tp_full(rank, shapes)
    with open(os.path.join(os.path.dirname(plan_path),
                           f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    torch.distributed.destroy_process_group()
    return 0


def check_tp_shapes(what: str, shapes: dict) -> None:
    """Every launch of a rank's TP run (``{C entry: shapes}``) at D_TP
    columns and at a shape that phases 2-30 held against plain
    (:data:`HELD`)."""
    bad = {k: [s for s in v if s[1] != D_TP or tuple(s) not in
               HELD.get(k, ())] for k, v in shapes.items()}
    bad = {k: v for k, v in bad.items() if v}
    if bad:
        raise AssertionError(
            f"{what}: launches not at {D_TP} columns or at a shape no phase "
            f"held against plain ({SHAPE_ARGS} gives the arguments): {bad}; "
            f"held: { {k: sorted(v) for k, v in HELD.items()} }")


def tp_reference(kind: str, mtx: str, epochs: int, packed=False) -> tuple:
    """(epoch mean losses, final parameters, Adam's first moments) of one
    process of the port's generic ``Trainer`` (the non-TP step of the
    same model: the v2 step kernels' ``fused_step_report`` /
    ``fused_step_boot(need_value=False)``, the vMF-VAE's ``forward`` +
    ``vmf_loss``), or with ``packed`` of its packed step, on the full
    parameters of phase 39's seed, fed the draws of the TP run's data
    index 0, dense-resident over phase 4's matrix."""
    from mmvae_tpu_torch.data.block import MtxMemoryBlock
    from mmvae_tpu_torch.ops.losses import vmf_loss
    from mmvae_tpu_torch.train.config import TrainingOptions
    from mmvae_tpu_torch.train.loop import (DenseEpochRunner, Trainer,
                                            build_dense, epoch_generator)

    model, step_cls = model_and_step(kind)
    topt = TrainingOptions()
    if packed:
        fast = step_cls(model, topt)
    elif kind == "vmf":
        fast = Trainer(lambda p, x, c, e, t: model.forward(p, x, c, e, t),
                       vmf_loss, topt, eps_widths=(model.latent,))
    else:
        widths = (2, 1, 2) if kind == "joint" else (2, 1)
        fast = Trainer(
            None, None, topt, eps_widths=widths,
            report_loss_override=lambda p, x, c, e, b:
            model.fused_step_report(p, x, c, e, b, include_data_const=True),
            boot_loss_override=lambda p, x, c, e, b:
            model.fused_step_boot(p, x, c, e, b, need_value=False))
    blk = MtxMemoryBlock(mtx, mtx + ".index", B_TRAIN, count_dtype="auto")
    runner = DenseEpochRunner(fast, build_dense(blk, DEV), B_TRAIN,
                              seed=SEED)
    q = fast.pack(model.init(torch.Generator().manual_seed(SEED),
                             device=DEV))
    st = fast.optimizer.init(q)
    losses = []
    for epoch in range(epochs):
        rand = fast.draw_rand(epoch_generator(SEED, epoch, DEV, 0),
                              runner.nbatch, B_TRAIN)
        q, st, reps, _ = runner(q, st, epoch, rand=rand)
        losses.append(float(reps.cpu().numpy().mean()))
    return losses, fast.unpack(q), fast.unpack_opt_state(st)["mu"]


def tp_vs_single(d: str, kind: str, mtx: str, epochs: int) -> tuple:
    """(largest |tp - single| / |single| of the scores, the largest
    err/tol of Adam's first moments and of the final parameters under
    :data:`TP_TOL`, each with its leaf) of a TP run (its last epoch's
    checkpoint: the gathered full arrays in JAX's TP layout) against
    :func:`tp_reference`."""
    losses, q, mu = tp_reference(kind, mtx, epochs)
    _, qp, _ = tp_reference(kind, mtx, epochs, packed=True)
    s_tp = np.loadtxt(os.path.join(d, "run.scores.gz"), ndmin=1)
    ck = dict(np.load(os.path.join(d, "ck", "ckpt.npz")))
    worst = {"mu": (0.0, ""), "params": (0.0, "")}

    def hold(what, name, a, w, tol):
        if a.shape != w.shape:
            raise AssertionError(f"{name}: shape {a.shape} vs {w.shape}")
        e = float(np.max(np.abs(a - w) / np.maximum(
            tol, np.finfo(np.float32).tiny), initial=0.0))
        if e > worst[what][0]:
            worst[what] = (e, name)

    for k, v in q.items():
        leaves = v.items() if isinstance(v, dict) else [(None, v)]
        m_k = mu[k].items() if isinstance(v, dict) else [(None, mu[k])]
        scale = max(float(t.abs().max()) for _, t in m_k)
        for (sub, w), (_, m) in zip(leaves, m_k):
            name = k + (f".{sub}" if sub else "")
            path = f"['{k}']" + (f"['{sub}']" if sub else "")
            p = (qp[k][sub] if sub else qp[k]).cpu().numpy()
            w, m = w.cpu().numpy(), m.cpu().numpy()
            hold("mu", name, ck[f"opt/[1].mu{path}"], m,
                 3e-3 * np.abs(m) + 1e-3 * scale)
            big = np.abs(m) >= 0.02 * np.abs(m).max()
            a = ck["params/" + k + (f"/{sub}" if sub else "")]
            floor = 2.0 * float(np.abs(p - w).max())
            hold("params", name, a[big], w[big], 3e-3 * np.abs(w[big])
                 + 2e-5 * np.abs(w).max() + floor)
    return float(np.max(np.abs(s_tp - losses) / np.abs(losses))), worst


def tp_encode_vs_one(card, tmp, run) -> str:
    """Phase 40 for one model: the TP sweep's artifacts against ``encode``
    in one process on the card (the folded kernel encoder; the TP
    encoder is the plain unfolded one): every posterior within phase
    12's tolerance (1e-4 * max|ref| + 1e-5 * |ref|), the mixture's
    assignments equal but for near-ties (as phase 16 allows), the rows
    compared where they agree."""
    from mmvae_tpu_torch.cli import encode

    one = os.path.join(run["dir"], "one")
    args = [a for a in run["args"]]
    i = args.index("--out")
    args[i + 1] = one
    i = args.index("--tensor_parallel")
    del args[i:i + 2]
    reset_launches()
    run_cli(encode, args)
    kind = run["kind"]
    names = (("latent_mean", "latent_lnvar") if kind == "vmf"
             else ("mu_mean", "mu_lnvar"))
    names += ("clust",) if kind == "mixture" else ()
    got = [np.loadtxt(os.path.join(run["dir"], f"enc.{k}.gz"), ndmin=2)
           for k in names]
    want = [np.loadtxt(f"{one}.{k}.gz", ndmin=2) for k in names]
    rows = np.ones(N_CLI, bool)
    if kind == "mixture":
        rows = got[2].argmax(1) == want[2].argmax(1)
        if (~rows).sum() > N_CLI // 1000 + 1:
            raise AssertionError(f"TP mixture assignments: "
                                 f"{int((~rows).sum())} differ")
    worst = 0.0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.shape[0] != N_CLI:
            raise AssertionError(f"{kind}: {g.shape} vs {w.shape}")
        g, w = g[rows], w[rows]
        lim = 1e-4 * np.abs(w).max() + 1e-5 * np.abs(w)
        worst = max(worst, float(np.max(np.abs(g - w) / lim)))
    if not worst <= 1.0:
        raise AssertionError(f"TP encode {kind} vs one process: err/tol "
                             f"{worst:.3g}")
    return (f"{len(names)} artifacts of ({N_CLI}, *) match the one-process "
            f"sweep (err/tol {worst:.3g}"
            + (f"; assignments equal on {int(rows.sum())} of {N_CLI} rows"
               if kind == "mixture" else "") + ")")


def tp_kernel_times(card) -> dict:
    """Phase 30's close: the TP launch shape of phases 39-41 (B = 100,
    D = D_TP, int8 integer counts, the compile-time widths): K1, K6,
    K6p, K2, K2p and K3 against their plain versions, device ms a launch
    (torch.profiler, after 50 warm-up calls each), with each one's bound
    at that shape."""
    from mmvae_tpu_torch.ops import nb_step as ns

    g = torch.Generator(device=DEV).manual_seed(SEED + 41)
    x, zc, zn, depth, Wj, (R, C, Rn) = joint_step_inputs(
        g, B_TRAIN, D_TP, torch.int8, "integer")
    Wn = Wj[:-1].contiguous()
    lr = ns.lse(zc, Wn, R, C)
    rs = ns.valgrad(x, zc, zn, depth, lr, Wn, R, C, Rn)[1].contiguous()
    cases = {
        "nb_lse": (lambda: ns.lse(zc, Wn, R, C),
                   lambda: ns.lse_ref(zc, Wn, R, C)),
        "nb_value": (lambda: ns.value(x, zc, zn, depth, lr, Wn, R, C, Rn),
                     lambda: ns.value_ref(x, zc, zn, depth, lr, Wn, R, C,
                                          Rn, True)),
        "nb_value[pb,nu_exp]": (
            lambda: ns.value(x, zc, zn, depth, lr, Wj, R, C, Rn, True, True),
            lambda: ns.value_ref(x, zc, zn, depth, lr, Wj, R, C, Rn, True,
                                 True)),
        "nb_valgrad": (
            lambda: ns.valgrad(x, zc, zn, depth, lr, Wn, R, C, Rn),
            lambda: ns.valgrad_ref(x, zc, zn, depth, lr, Wn, R, C, Rn)),
        "nb_valgrad[pb,nu_exp]": (
            lambda: ns.valgrad(x, zc, zn, depth, lr, Wj, R, C, Rn, True),
            lambda: ns.valgrad_ref(x, zc, zn, depth, lr, Wj, R, C, Rn,
                                   True)),
        "nb_finish": (lambda: ns.finish(zc, lr, rs, Wn, R, C),
                      lambda: ns.finish_ref(zc, lr, rs, Wn, R, C))}
    shape = dict(B=B_TRAIN, D=D_TP, x_bytes=1, dtype="int8")
    out = {}
    for name, (kern, plain) in cases.items():
        for fn in (kern, plain) * 50:
            fn()
        ms, _ = device_profile(kern, 20)
        p_ms, _ = device_profile(plain, 20)
        b_ms, b_by = bound_ms(name, dict(shape, dtype="")
                              if name in ("nb_lse", "nb_finish") else shape)
        out[name] = dict(ms=ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by)
    log(f"[phase 30] [{card}] the TP launch shape B={B_TRAIN} D={D_TP} int8 "
        f"(held against plain in phases 28-30), device ms a launch, kernel "
        f"/ plain (bound): " + "; ".join(
            f"{k} {v['ms']:.4f} / {v['plain_ms']:.4f} ({v['bound_ms']:.5f}, "
            f"{v['bound_by']})" for k, v in out.items()))
    return out


def phase_tp(card, tmp, mtx, rate9):
    """Phases 39-41: two ranks of one model row (NCCL on two cards when
    there are two, gloo with both on the one card otherwise), each a
    process of this script with its own timeout."""
    runs = tp_runs(tmp, mtx)
    plan = os.path.join(tmp, "tp", "plan.json")
    with open(plan, "w") as f:
        json.dump({"coordinator": f"127.0.0.1:{free_port()}", "runs": runs},
                  f)
    env = dict(os.environ, MMVAE_DIST_TIMEOUT="120")
    logs = [open(os.path.join(tmp, "tp", f"rank{r}.log"), "w+")
            for r in range(TP_WORLD)]
    t0 = time.time()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--tp-worker", str(r), plan], env=env,
                              stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(TP_WORLD)]
    try:
        for p in procs:
            p.wait(timeout=480)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    texts = []
    for f in logs:
        f.seek(0)
        texts.append(f.read())
        f.close()
    if any(p.returncode != 0 for p in procs):
        raise AssertionError("a TP rank failed:\n" + "\n---\n".join(
            t[-4000:] for t in texts))
    res = []
    for r in range(TP_WORLD):
        with open(os.path.join(tmp, "tp", f"rank{r}.json")) as f:
            res.append(json.load(f))
    backend = re.search(r"backend (\w+) \(([^;]*);", texts[0])
    log(f"[phase 39] [{card}] {TP_WORLD} ranks of --tensor_parallel {TP_N}, "
        f"backend {backend.group(1)} ({backend.group(2)}; "
        f"{torch.cuda.device_count()} device(s)); ranks ran "
        f"{time.time() - t0:.1f}s")
    totals = {}
    for run in runs:
        name, d, kind = run["name"], run["dir"], run["kind"]
        per_rank = [x["runs"][name] for x in res]
        path = [] if run["cli"] == "encode" else TP_PATHS[kind]
        for r, got in enumerate(per_rank):
            lau = got["launches"]
            if (path and min(lau[k] for k in path) < 1) or any(
                    n for k, n in lau.items() if k not in path):
                raise AssertionError(f"{name} rank {r}: launches {lau}")
            check_tp_shapes(f"{name} rank {r}", got["shapes"])
            for k in path:
                totals[k] = totals.get(k, 0) + lau[k]
        if run["cli"] == "encode":
            if per_rank[0]["tier"] != "TP serving":
                raise AssertionError(f"{name}: {per_rank[0]['tier']}")
            line = tp_encode_vs_one(card, tmp, run)
            log(f"[phase 40] [{card}] encode --model {run['args'][1]} "
                f"--tensor_parallel {TP_N} on phase 39's {kind} checkpoint:"
                f" no kernel launched (the TP encoder is plain, as in JAX); "
                f"{line}; wall {per_rank[0]['wall']:.2f}s")
            continue
        finals = [dict(np.load(os.path.join(d, f"final_rank{r}.npz")))
                  for r in range(TP_WORLD)]
        if not all(np.array_equal(finals[0][k], x[k]) for x in finals[1:]
                   for k in finals[0]):
            raise AssertionError(f"{name}: the ranks' parameters differ")
        if os.path.exists(os.path.join(d, "ck_rank1")):
            raise AssertionError(f"{name}: rank 1 wrote a checkpoint")
        scores = np.loadtxt(os.path.join(d, "run.scores.gz"), ndmin=1)
        if not np.isfinite(scores).all():
            raise AssertionError(f"{name}: scores {scores}")
        if per_rank[0]["tier"] != "dense-resident TP layout":
            raise AssertionError(f"{name}: {per_rank[0]['tier']}")
        extra = ""
        if name in ("nb", "joint", "mixture", "vmf"):
            e_s, w = tp_vs_single(d, kind, mtx, run["epochs"])
            line = (f"scores rel {e_s:.3g}, first moments err/tol "
                    f"{w['mu'][0]:.3g} ({w['mu'][1]}), parameters err/tol "
                    f"{w['params'][0]:.3g} ({w['params'][1]})")
            if not (e_s <= 2e-4 and w["mu"][0] <= 1.0
                    and w["params"][0] <= 1.0):
                raise AssertionError(f"{name} TP vs one process: {line}")
            extra = (f"; against one process of the generic Trainer on "
                     f"the same draws: {line} ({TP_TOL})")
        if name == "nb_r":
            if not per_rank[0]["resumed"]:
                raise AssertionError("nb_r did not resume")
            want = dp_outputs(os.path.join(tmp, "tp", "nb"))
            if not same_outputs(dp_outputs(d), want):
                raise AssertionError("the resumed TP run differs from the "
                                     "uninterrupted one")
            extra = f"; equals the uninterrupted run bitwise ({len(want)} " \
                    f"files and arrays)"
        log(f"[phase 39] [{card}] {name} ({TP_CLI[kind]} --tensor_parallel "
            f"{TP_N}, {run['epochs']} epoch(s), dense-resident TP layout): "
            f"scores {scores.tolist()}; launches rank 0 "
            f"{ {k: per_rank[0]['launches'][k] for k in path} }, rank 1 "
            f"{ {k: per_rank[1]['launches'][k] for k in path} }, K4 and K5 "
            f"0, every launch at {D_TP} columns and at one of "
            f"{sum(map(len, per_rank[0]['shapes'].values()))} shapes "
            f"(rank 0) held against plain in phases 28-30; ranks' final "
            f"parameters bitwise equal; rank 0 alone wrote; wall "
            f"{per_rank[0]['wall']:.2f}s{extra}")
    need = ("nb_lse", "nb_valgrad", "nb_valgrad[pb,nu_exp]", "nb_finish",
            "nb_value", "nb_value[pb,nu_exp]")
    if any(totals.get(k, 0) < 1 for k in need):
        raise AssertionError(f"phase 39 launched no {need}: {totals}")
    full = [x["full"] for x in res]
    for r, fr in enumerate(full):
        if not (np.isfinite(fr["losses"]).all()
                and fr["losses"][1] < fr["losses"][0]):
            raise AssertionError(f"phase 41 rank {r}: losses {fr['losses']}")
        if any(fr["launches"].get(k, 0) <= 0 for k in TP_PATHS["nb"]) or \
                set(fr["launches"]) - set(TP_PATHS["nb"]):
            raise AssertionError(f"phase 41 rank {r}: {fr['launches']}")
        check_tp_shapes(f"phase 41 rank {r}", fr["shapes"])
    if full[0]["q_sha"] != full[1]["q_sha"]:
        raise AssertionError("phase 41: the ranks' parameters differ")
    rate = full[0]["rate"]
    log(f"[phase 41] [{card}] NB, generic TP step, --tensor_parallel {TP_N} "
        f"({backend.group(1)}) x {D_TP} features a rank, {N_SHORT} x "
        f"{D_GENES} int8, 2 epochs: epoch losses {full[0]['losses'][0]:.4f}"
        f" -> {full[0]['losses'][1]:.4f}; second epoch {rate:,.1f} cells/sec"
        f" (both ranks on the same rows) against phase 9's {rate9:,.1f} on "
        f"one process with the packed step ({rate / rate9:.2f}x); launches "
        f"a batch {full[0]['launches']}")
    for r, fr in enumerate(full):
        log(f"[phase 41] [{card}] rank {r}: {fr['per_batch_ms']:.3f} ms wall "
            f"a batch (second epoch); profile of 20 batches: device busy "
            f"{fr['busy_ms']:.3f} ms a batch, of it copies "
            f"{fr['copy_ms']:.3f} ms"
            + (f", beside NCCL's kernels {fr['comm_ms']:.3f} ms (most of it "
               f"waiting for the peer)" if fr["comm_ms"] else "")
            + " (device idle share "
            + (f"{fr['idle']:.1%}" if fr["idle"] is not None else
               "not measured: the trace holds no device events")
            + f"); collectives {fr['allreduce_ms']:.3f} ms a batch in "
            f"{fr['allreduce_calls']:g} all-reduces of "
            f"{fr['allreduce_bytes'] / 1e3:.2f} kB on average (host clock, "
            f"device synchronised around each)")
    return {"rate": rate, "totals": totals}


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# H100 SXM published peaks (NVIDIA data sheet, 700 W): HBM3 bytes/s and
# float32 FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
# operations per (row, column) element of each kernel, counted from its
# source on the main path's integer-count regime (an add, a multiply or a
# transcendental is 1, an FMA 2), at R = 2, C = 1, Rn = 1
OPS_PER_ELEMENT = {
    "nb_lse": 11,        # logits 7, exp of the shifted logit 2, online sum 2
    "nb_value": 80,      # logits 7, mu 4, nu 11, mixed-regime lgamma ~47,
                         # the three logs and the value terms 11
    "nb_value[pb,nu_exp]": 76,    # logits 7, mu 5 (the exp(pb) multiply),
                         # nu 6 (nu_pre 3, exp, min, add), lgamma ~47,
                         # the three logs and the value terms 11
    "nb_valgrad": 110,   # logits 7, mu 4, nu 11, mixed-regime digamma ~56,
                         # the shared divide 8, dls/dnu 16, sums 8
    "nb_valgrad[pb,nu_exp]": 101,  # logits 7, mu 5, nu 6, digamma ~56,
                         # the shared divide 3 (no sigmoid), dls/dnu 15
                         # (one clamp test), sums 9 (with the pb row)
    "nb_finish": 22,     # logits 7, p 3, fout 8, u2 4
    "nb_valgrad[value]": 164,  # nb_valgrad's 110, the mixed-regime
                         # lgamma ~47 and the value terms 7
    "nb_valgrad[pb,nu_exp,value]": 155,  # nb_valgrad[pb,nu_exp]'s 101,
                         # the mixed-regime lgamma ~47 and the value terms 7
    "nb_elbo_fwd": 71,   # max and regime scan 7; sum of exp 3; p, mu 4;
                         # softplus and nu 8; the one divide 5; t, dmu p
                         # 5; the select-products and -log P 29; the two
                         # log ratios 8; the two row sums 2 (the counts
                         # > 7, ~1%, add a Stirling correction)
    "nb_elbo_fwd[const]": 90,  # and the select-products of Pc and Pc / P
    "nb_elbo_bwd": 102,  # regime scan 7; p, mu 4; softplus and nu 8;
                         # the regime test 1; the select-products of P
                         # and dP and dP / P
                         # 50; the shared divide 10; inv_mn, inv_mu, t,
                         # dmu 6; dh 5; dnu's log and sum 5; the mask 6
}


def bound_ms(name: str, shape: dict) -> tuple[float, str]:
    """The least time the card could take for the kernel's work on the
    main path's shape: the larger of (each input read once, each output
    written once) / HBM rate and operations / float32 rate."""
    B, D, xb = shape["B"], shape["D"], shape["x_bytes"]
    if name == "roofline_probe":
        # the fma class at ILP 4, nrep 40: 4 x 40 FFMAs (2 operations each)
        # an element; x read and the output written once
        ops, nbytes = B * D * 40 * 4 * 2, 2 * B * D * 4
    elif name.startswith("count_encode"):
        r = shape["r1"] + shape["r2"]
        # the row stats: an add and an FMA (3); the filtered pair: a
        # multiply by the mask, an add and an FMA (4 more), and the mask
        stats = name.endswith(("[stats]", "[filt]"))
        filt = name.endswith("[filt]")
        if name == "count_encode_bwd":
            nbytes = B * D * xb + B * r * 4 + r * D * 4
        else:
            nbytes = (B * D * xb + r * D * 4 + B * r * 4
                      + (B * 16 if stats else 0) + (D * 4 if filt else 0))
        ops = B * D * (2 * r + 1 + (3 if stats else 0) + (4 if filt else 0))
    else:
        R, C, Rn = 2, 1, 1
        T = R + C + Rn + 2 + (1 if "[pb" in name else 0)
        base = name.split("[")[0]
        ops = B * D * OPS_PER_ELEMENT[name]
        rows = B * (R + C + Rn + 2) * 4          # latents, depth, lse
        if base == "nb_lse":
            nbytes = B * (R + C) * 4 + (R + C + 1) * D * 4 + B * 4
        elif base == "nb_value":
            nbytes = B * D * xb + T * D * 4 + rows + 4
        elif base == "nb_valgrad":
            nbytes = (B * D * xb + T * D * 4 + rows + T * D * 4
                      + B * (1 + R + Rn) * 4 + 4)
        elif base == "nb_elbo_fwd":
            # x, h, nu_pre and depth read once (a row of h fits on chip,
            # so the second pass need not reread it); lse, rowsum,
            # ddepth and the NLL written
            nbytes = B * D * (xb + 8) + B * 4 + B * 12 + 4
        elif base == "nb_elbo_bwd":
            # x, h, nu_pre, g and the three (B, 1) rows read; dh, dnu
            nbytes = B * D * (xb + 8) + 4 + B * 12 + B * D * 8
        else:  # nb_finish
            nbytes = (B * (R + C + 2) * 4 + 2 * (R + C + 1) * D * 4
                      + B * R * 4)
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / PEAK_F32
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from mmvae_tpu_torch.ops import _cuda
    from mmvae_tpu_torch.ops import enc_kernel as enc

    from mmvae_tpu_torch.utils.profiling import card_line

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"[phase 0] card: {card}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}; {torch.cuda.device_count()} device(s)")

    t0 = time.time()
    _cuda.build(force=True)
    _cuda.lib()
    log(f"[phase 1] built {', '.join(os.path.relpath(s) for s in _cuda.sources())}"
        f" -> {os.path.relpath(_cuda.LIB_PATH)} in {time.time() - t0:.1f}s")
    with open(_cuda.BUILD_LOG) as f:
        build_log = f.read()
    log(f"[phase 1] ptxas ({os.path.relpath(_cuda.BUILD_LOG)} has the "
        f"full report): {ptxas_summary(build_log)}")
    for source, label in (("count_encode.cu", encode_label),
                          ("nb_valgrad.cu", valgrad_label),
                          ("count_encode_bwd.cu", bwd_label),
                          ("nb_lse.cu", lse_label),
                          ("nb_value.cu", value_label),
                          ("nb_finish.cu", finish_label),
                          ("nb_elbo.cu", elbo_label)):
        log(f"[phase 1] {source} instances (registers / spilled bytes): "
            + ", ".join(f"{n} {r}r/{b}B" for n, r, b in
                        check_instances(build_log, source, label)))

    marks = [("build", time.time())]

    def mark(name):
        marks.append((name, time.time()))

    worst, times = {}, {}
    worst["count_encode"], (times["count_encode"], train_k4) = (
        phase_kernels(enc, card))
    phase_chunks(enc)
    mark("2-3")
    # every launch of these phases is held against its plain version;
    # their times are device times, which the recording leaves alone
    with launch_shapes(HELD):
        for w, t in (phase_variant_kernels(card), phase_train_kernels(card)):
            worst.update(w)
            times.update(t)
        (worst["count_encode[filt]"], times["count_encode[filt]"],
         times["count_encode_bwd mixture"]) = phase_filt_kernels(card)
        mark("6, 10, 14")
        for w, t in (phase_generic_kernels(card), phase_k2pv(card)):
            worst.update(w)
            times.update(t)
        for name, e in phase_valgrad_cases(card).items():
            worst[name] = max(worst[name], e)
        mark("18, 22, 28")
        w29, bwd_times = phase_bwd_lse_cases(card)
        for name, e in w29.items():
            worst[name] = max(worst[name], e)
        mark("29")
        w30, _ = phase_value_finish_cases(card)
        for name, e in w30.items():
            worst[name] = max(worst[name], e)
        tp_times = tp_kernel_times(card)
        mark("30")
    worst["roofline_probe"], times["roofline_probe"], p1_launches = (
        phase_roofline(card))
    mark("26")
    for kind in ("nb", "joint", "mixture"):
        phase_batch_step(card, kind)
    phase_generic_step(card)
    phase_vmfnb_generic_step(card)
    phase_vmf_step(card)
    mark("7, 11, 15, 19, 23, 32")
    with tempfile.TemporaryDirectory() as tmp:
        serve_launches, mtx = phase_cli(card, tmp)
        mark("4")
        nb_launches, _ = phase_train_cli(card, tmp, mtx)
        wide_launches = phase_wide_cli(card, tmp, mtx)
        j_launches, ck = phase_train_cli(card, tmp, mtx, "joint")
        enc_launches = phase_joint_encode(card, tmp, mtx, ck)
        m_launches, mck = phase_train_cli(card, tmp, mtx, "mixture")
        menc_launches = phase_mixture_encode(card, tmp, mtx, mck)
        g_launches, r_launches = phase_generic_cli(card, tmp, mtx)
        vj_launches, vm_launches, v_lib = phase_vmfnb_generic_cli(card, tmp,
                                                                  mtx)
        mark("8, 31, 12, 16, 20, 24")
        phase_vmf_cli(card, tmp, mtx)
        mark("33")
        phase_feature_perm(card, tmp, mtx)
        mark("42")
        phase_tiers(card, tmp, mtx)
        mark("35")
        phase_tooling(card, tmp, mtx)
        mark("27")
        data = full_size_counts()
        phase_full(card, data)
        phase_full_vmf(card, data)
        mark("5")
        full = {}
        for kind in ("nb", "joint", "mixture", "generic", "library", "vmf"):
            full[kind] = phase_train_full(card, data, kind)
            mark(str(PHASE[kind]["full"]))
        phase_rotating_full(card, data, full["nb"])
        mark("36")
        phase_superbatch(card, data, tmp)
        mark("43")
        rate9 = full["nb"]["rate"]
        del data, full
        torch.cuda.empty_cache()
        phase_dp(card, tmp, mtx, rate9)
        mark("37-38")
        tp = phase_tp(card, tmp, mtx, rate9)
        mark("39-41")
    log("[timing] seconds by phase: " + "; ".join(
        f"{b[0]} {b[1] - a[1]:.1f}" for a, b in zip(marks, marks[1:]))
        + f"; since the build {marks[-1][1] - t0:.1f}")
    launches = {k: nb_launches[k] for k in NB_PATH}
    launches.update({k: j_launches[k] for k in JOINT_PATH
                     if k not in NB_PATH})
    launches["count_encode[filt]"] = m_launches["count_encode[filt]"]
    launches.update({k: g_launches[k] for k in GENERIC_PATH
                     if k.startswith("nb_elbo")})
    launches["nb_valgrad[value]"] = r_launches["nb_valgrad[value]"]
    launches["nb_valgrad[pb,nu_exp,value]"] = v_lib["joint"][
        "nb_valgrad[pb,nu_exp,value]"]
    launches["roofline_probe"] = p1_launches

    log(f"[summary] serving CLI (nb): {serve_launches} count_encode "
        f"launches; training CLIs: nb_vae "
        f"{ {k: nb_launches[k] for k in NB_PATH} }, vmfnb_vae "
        f"{ {k: j_launches[k] for k in JOINT_PATH} }, vmfnb_vae --annot "
        f"{ {k: m_launches[k] for k in MIXTURE_PATH} }; encode --model "
        f"vmfnb: {enc_launches} count_encode[stats] launches; encode "
        f"--model mixture: {menc_launches} count_encode[filt] launches; "
        f"nb_vae --mean_encoding 16 --mean_decoding 16 "
        f"{ {k: g_launches[k] for k in GENERIC_PATH} }; README library "
        f"trainer { {k: r_launches[k] for k in README_PATH} }; vmfnb_vae "
        f"--mean_encoding 16 --vmf_decoding 16 "
        f"{ {k: vj_launches[k] for k in JOINT_PATH} }, vmfnb_vae --annot "
        f"--mean_encoding 16 { {k: vm_launches[k] for k in MIXTURE_PATH} }"
        f"; nb_vae --mean_latent 13 "
        f"{ {k: wide_launches[k] for k in NB_PATH} }"
        f"; library trainers: joint "
        f"{ {k: v_lib['joint'][k] for k in JOINT_VALUE_PATH} }, mixture "
        f"{ {k: v_lib['mixture'][k] for k in MIXTURE_VALUE_PATH} }"
        f"; vmf_vae, encode --model vmf and the vMF step and sweep "
        f"(phases 32-34, 5): no kernel launched")
    log(card)
    int8 = dict(B=B_TRAIN, D=D_GENES, x_bytes=1, dtype="int8")
    shapes = {"count_encode": dict(int8, B=1600, r1=2, r2=0),
              "count_encode[stats]": dict(int8, r1=5, r2=3),
              "count_encode[filt]": dict(int8, r1=12, r2=3),
              "count_encode_bwd": dict(int8, r1=2, r2=2),
              "roofline_probe": dict(int8, x_bytes=4, dtype="float32"),
              # these two take no counts
              "nb_lse": dict(int8, dtype=""),
              "nb_finish": dict(int8, dtype="")}

    def label(shape):
        return (f"M={shape['B']} D={shape['D']}"
                + (f" {shape['dtype']}" if shape["dtype"] else "")
                + (f" rows {shape['r1']} + {shape['r2']}" if "r1" in shape
                   else ""))

    records = []
    for name, _, _, src, rep in KERNELS:
        shape = shapes.get(name, int8)
        b_ms, b_by = bound_ms(name, shape)
        records.append({
            "name": name, "route": "cuda",
            "source": f"mmvae_tpu_torch/csrc/{src}",
            "replaces": rep,
            "launches": launches[name], "max_abs_err": worst[name],
            "ms": times[name][0], "plain_ms": times[name][1],
            "bound_ms": b_ms, "bound_by": b_by,
            # no single PyTorch call computes any of these functions (K5's
            # two products are set below)
            "library_ms": None, "shape": label(shape)})
    # K4 at the NB trainer's launch, beside the serving launch above
    train = dict(int8, r1=2, r2=2)
    records[0]["trainer"] = {
        "shape": label(train), "ms": train_k4[0], "plain_ms": train_k4[1],
        "bound_ms": bound_ms("count_encode", train)[0]}
    # K5: the library's two products beside the NB trainer's launch, and
    # the joint and mixture trainers' launches
    k5 = next(r for r in records if r["name"] == "count_encode_bwd")
    k5["library_ms"] = bwd_times[(2, 2)]["library_ms"]
    for model, (r1, r2) in (("joint", (5, 3)), ("mixture", (12, 3))):
        sh = dict(int8, r1=r1, r2=r2)
        k_ms, p_ms = times[f"count_encode_bwd {model}"]
        k5[model] = {"shape": label(sh), "ms": k_ms, "plain_ms": p_ms,
                     "bound_ms": bound_ms("count_encode_bwd", sh)[0],
                     "library_ms": bwd_times[(r1, r2)]["library_ms"]}
    # the step kernels at the TP launch shape: phase 41's times, phase
    # 39's launches (both ranks, all four trainers)
    for r in records:
        if r["name"] in tp_times:
            r["tp"] = {"shape": f"B={B_TRAIN} D={D_TP} int8",
                       "launches": tp["totals"].get(r["name"], 0),
                       **tp_times[r["name"]]}
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-worker"]:
        sys.exit(dp_worker(int(sys.argv[2]), sys.argv[3]))
    if sys.argv[1:2] == ["--tp-worker"]:
        sys.exit(tp_worker(int(sys.argv[2]), sys.argv[3]))
    sys.exit(main())
