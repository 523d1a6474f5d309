"""The training driver: one run of a training cell on one card.

Set-up (``setup_s``: from the process's start to the window's start):
the imports, the kernel library (``_cuda.lib()``), the counts made on
the card from the seed, the genes clustered as the CLI clusters them
(``cluster_features``), the step built and packed from the benchmark's
parameters, and epoch 0 through the window's own call,
``DenseEpochRunner.__call__`` with the superbatch graphs, on draws the
benchmark makes: its first replay captures the graph, and the state
after that replay is kept for the comparison (``judge.py``).  Then warm
epochs, as the window runs them, until ``warm_s`` seconds have passed
since the set-up began training and the card runs graphs at its fast
speed (``probe.py``), or ``warm_cap_s`` seconds have passed; and last
the check epoch: a warm epoch on draws the benchmark makes, whose state
is kept before and after its middle replay for the second comparison.

Window: whole epochs, each ``DenseEpochRunner.__call__`` on the
program's own draws ended by its loss fetch, as ``train_vae_model``
runs them, until the first epoch end after ``seconds``.
``train_cells_per_s`` is every cell stepped in the window over the
window's wall.  With ``trace`` one more epoch after the window profiles
a run of whole replays (``trace.py``).

After the window: the peak device memory is read, the program's state
freed, and the plain reference follows the two checked replays (the
first from the benchmark's parameters, the second from the program's
state before it) and the comparison decides ``correct``.
"""

from __future__ import annotations

import time

import torch

from .. import counts, flops, judge
from ..probe import FAST_US, NodeProbe
from ..reference import common
from ..trace import Reading, breakdown, check_launches, reduce_events

#: every key a traffic file of this driver may hold; any other is refused
TRAFFIC_KEYS = frozenset({
    "driver", "about", "cells", "count_dtype", "counts_per_cell",
    "row_block", "superbatch", "feature_clustering", "warm_s", "warm_cap_s",
    "profile_after_replays", "profile_replays"})

#: cycles of the spin kernel that holds the card while the host enqueues
#: one traced replay (about 0.1 s at the H100's 1,980 MHz)
SPIN_CYCLES = 200_000_000


class _Profile:
    """``on_batch`` of the traced epoch: after replay ``after``, with the
    card idle, starts the profiler, and stops it ``n`` replays later,
    keeping the launch counts the replays booked.  On a card, before
    each traced replay it waits for the card to go idle and launches a
    spin kernel (``trace.py``), so that the host has enqueued the
    replay's copies and graph before the card reaches them: under the
    profiler a graph launch waits for the previous replay to end.  On
    the CPU the sub-window is the host clock's."""

    def __init__(self, device, S: int, after: int, n: int):
        self.cuda, self.device = device.type == "cuda", device
        self.S, self.after, self.n = S, after, n
        self.prof = self.c0 = self.t0 = self.host_s = None
        self.counters: dict = {}
        self.replay = 0

    def __call__(self, b, rep):
        from mmvae_tpu_torch.train.superbatch import count_delta, read_counts

        self.replay += 1
        if not self.after <= self.replay <= self.after + self.n:
            return
        if self.cuda:
            torch.cuda.synchronize(self.device)
        if self.replay == self.after:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.cuda:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.start()
            self.t0, self.c0 = time.perf_counter(), read_counts()
        if self.replay == self.after + self.n:
            self.host_s = time.perf_counter() - self.t0
            self.prof.stop()
            self.counters = count_delta(read_counts(), self.c0)
        elif self.cuda:
            torch.cuda._sleep(SPIN_CYCLES)

    def reading(self) -> Reading:
        if self.host_s is None:
            raise RuntimeError(f"the traced epoch ended before replay "
                               f"{self.after + self.n}")
        r = Reading(window_s=0.0 if self.cuda else self.host_s,
                    batches=self.n * self.S, replays=self.n,
                    counters=self.counters)
        return reduce_events(self.prof.events(), r)


class _Snapshots:
    """``on_batch`` of the check epoch: the static state after replay
    ``k`` and after replay ``k + 1``."""

    def __init__(self, runner, k: int):
        self.runner, self.k, self.replay = runner, k, 0
        self.before = self.after = None

    def __call__(self, b, rep):
        self.replay += 1
        if self.replay == self.k:
            self.before = self.runner.graphs.state()
        elif self.replay == self.k + 1:
            self.after = self.runner.graphs.state()


def _check_data(cell, seed: int, device, epoch: int, b0: int, S: int):
    """The inputs of batch steps ``b0 .. b0 + S - 1`` of epoch ``epoch``
    as the benchmark made them: each step's (counts, covariate, draws),
    in input gene order."""
    cfg, tr = cell.config, cell.traffic
    M = int(cfg["batch_size"])
    rb = int(tr["row_block"])
    nbatch = int(tr["cells"]) // M
    C = cell.module("models").covar_dim(cfg)
    dr = counts.draws(seed, epoch, nbatch, M, cfg["nboot"],
                      cell.module("reference").eps_widths(cfg), device)
    per = M // rb
    blocks = counts.rank_blocks(nbatch, M, 0, 1, rb)[b0 * per:(b0 + S) * per]
    x = counts.make_blocks(seed, blocks, tr, cfg["data_dim"], device)
    c = torch.ones((M, C), device=device)
    return [(x[j * M:(j + 1) * M], c,
             {"rep_eps": tuple(e[b0 + j] for e in dr["rep_eps"]),
              "ridx": dr["ridx"][b0 + j],
              "boot_eps": tuple(e[b0 + j] for e in dr["boot_eps"])})
            for j in range(S)]


def reference_run(cell, seed: int, device, fault=None, tf32=False,
                  start: dict | None = None) -> dict:
    """The plain reference over a checked replay at the cell's own
    sizes, on ``device``: the first replay of epoch 0 from the
    benchmark's parameters, or with ``start`` (``epoch``, ``b0``, the
    program's ``params``, ``mu``, ``nu`` and ``count`` before the replay,
    in input gene order) the replay of the check epoch that begins at
    batch ``b0``."""
    S = int(cell.traffic["superbatch"])
    cfg = cell.config
    ref = cell.module("reference")
    params = ref.init_params(cfg, counts.param_generator(seed, device),
                             device)
    epoch, b0, state = 0, 0, None
    if start is not None:
        epoch, b0 = start["epoch"], start["b0"]
        params = common.rebuild(params, {k: v.to(device) for k, v in
                                         start["params"].items()})
        state = {"count": start["count"],
                 "mu": {k: v.to(device) for k, v in start["mu"].items()},
                 "nu": {k: v.to(device) for k, v in start["nu"].items()}}
    steps = _check_data(cell, seed, device, epoch, b0, S)

    def loss(p, x, c, eps, beta, const):
        return ref.loss(cfg, p, x, c, eps, beta, const)

    with common.matmul_precision(tf32):
        out = common.follow(loss, cfg, params, steps,
                            common.kl_weight(cfg, epoch), fault, state)
    return {k: (({n: t.detach().cpu() for n, t in v.items()})
                if isinstance(v, dict) else v) for k, v in out.items()}


def run(cell, seed: int, seconds: float, trace: bool, device: torch.device,
        t_start: float, log) -> dict:
    """One run of ``cell``; the result's fields."""
    from mmvae_tpu_torch.train.loop import DenseEpochRunner, cluster_features, \
        permute_d_axes

    cfg, tr = cell.config, cell.traffic
    M = int(cfg["batch_size"])
    S = int(tr["superbatch"])
    D = cfg["data_dim"]
    cuda = device.type == "cuda"
    if cuda:
        from mmvae_tpu_torch.ops import _cuda

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        _cuda.lib()
    build = cell.module("models")
    ref = cell.module("reference")
    nbatch = int(tr["cells"]) // M
    nrep = -(-nbatch // S)
    rb = int(tr["row_block"])
    xb = counts.DTYPES[tr["count_dtype"]][0].itemsize
    data = counts.make_blocks(seed, counts.rank_blocks(nbatch, M, 0, 1, rb),
                              tr, D, device)
    perm = gmax = None
    t_ref = 0.0
    if tr.get("feature_clustering"):
        # the reference's view of the counts, for the order it works out
        # (a millisecond, kept out of the set-up)
        t = time.perf_counter()
        gmax = torch.amax(data, 0)
        if cuda:
            torch.cuda.synchronize(device)
        t_ref = time.perf_counter() - t
        data, perm = cluster_features(data, build.covar_dim(cfg))
    fast = build.build(cfg, tr, seed)
    params = ref.init_params(cfg, counts.param_generator(seed, device),
                             device)
    if perm is not None:
        params = permute_d_axes(params, perm, D)
    runner = DenseEpochRunner(fast, data, M, seed=seed,
                              covar_dim=build.covar_dim(cfg), superbatch=S)
    q = fast.pack(params)
    po = fast.optimizer.init(q)
    p0 = _cpu_leaves(params)
    del params
    first: dict = {}

    def first_replay(b, rep):
        if not first:
            first["after"] = runner.graphs.state()

    t_train = time.perf_counter()
    q, po, reps0, _ = runner(q, po, 0, rand=_draws(cell, seed, 0, device),
                             on_batch=first_replay)
    loss0 = float(reps0.cpu().numpy().mean())
    # warm epochs: some processes start with the card at its slow speed
    # for seconds (probe.py, PERF.md); train on until warm_s has passed
    # and the card reads fast, or warm_cap_s has passed
    probe = NodeProbe(device) if cuda else None
    epoch, warm_walls, probes = 1, [], []
    while True:
        elapsed = time.perf_counter() - t_train
        us = probe.us_per_node() if probe is not None else None
        probes.append(us)
        slow = us is not None and us > FAST_US
        if elapsed >= float(tr["warm_s"]) and (
                not slow or elapsed >= float(tr["warm_cap_s"])):
            break
        t = time.perf_counter()
        q, po, reps, _ = runner(q, po, epoch)
        float(reps.cpu().numpy().mean())
        warm_walls.append(time.perf_counter() - t)
        epoch += 1
    if slow:
        log(f"warm-up: the card still reads {us:.4f} us a graph node after "
            f"{elapsed:.1f} s (fast under {FAST_US}); the window may run "
            f"at the slow speed")
    check_epoch, k = epoch, nrep // 2
    snaps = _Snapshots(runner, k)
    q, po, reps, _ = runner(q, po, check_epoch,
                            rand=_draws(cell, seed, check_epoch, device),
                            on_batch=snaps)
    float(reps.cpu().numpy().mean())
    epoch += 1
    prog = [_program_side(fast, p0, first["after"], reps0[:S]),
            _program_side(fast, None, snaps.after, reps[k * S:(k + 1) * S],
                          snaps.before)]
    del first, snaps, p0

    # ---- the window -------------------------------------------------
    t0 = time.perf_counter()
    setup_s = time.time() - t_start - t_ref
    epochs = failed = 0
    walls = []
    while True:
        q, po, reps, _ = runner(q, po, epoch)
        host = reps.cpu().numpy()
        loss = float(host.mean())
        failed += int((~torch.isfinite(torch.from_numpy(host))).sum())
        epochs += 1
        epoch += 1
        walls.append(time.perf_counter() - t0)
        if walls[-1] >= seconds:
            break
    wall = time.perf_counter() - t0
    if probe is not None:
        probes.append(probe.us_per_node())
        probe.close()
    reading = None
    if trace:
        prof = _Profile(device, S, int(tr["profile_after_replays"]),
                        int(tr["profile_replays"]))
        q, po, reps, _ = runner(q, po, epoch, on_batch=prof)
        float(reps.cpu().numpy().mean())
        reading = prof.reading()
        reading.notes += check_launches(reading)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    stats = dict(runner.graph_stats)

    # ---- free the program's state ------------------------------------
    runner.close()
    del runner, data, q, po, fast, reps, reps0
    if cuda:
        torch.cuda.empty_cache()

    ends = " ".join(f"{w:.3f}" for w in walls)
    log(f"window: {epochs} epochs of {nbatch} batches in {wall:.3f} s, "
        f"epochs ending at {ends} s (set-up {setup_s:.3f} s, warm epochs "
        f"{' '.join(f'{w:.3f}' for w in warm_walls)} s, check epoch "
        f"{check_epoch}, epoch 0 loss {loss0:.6f}, last {loss:.6f}; us a "
        f"graph node before each warm epoch, then after the window: "
        f"{' '.join('-' if u is None else f'{u:.4f}' for u in probes)})")
    if gmax is not None:
        # the program trained in its clustered order: put its trees back
        # in input order by the order the reference works out
        order = common.cluster_order(gmax, device.type,
                                     build.covar_dim(cfg))
        if order is not None:
            back = torch.argsort(order)
            prog = [_in_order(p, back, D) for p in prog]
    late = prog[1].pop("start")
    late.update(epoch=check_epoch, b0=k * S)
    nums = []
    for name, p, start in zip(("first", "late"), prog, (None, late)):
        n = judge.readings(p, reference_run(cell, seed, device, start=start),
                           ref.ENCODER_LEAF)
        log(f"check ({name} replay): worst leaves {n.pop('_leaves')}")
        log(f"numbers ({name} replay): "
            + " ".join(f"{a}={v!r}" for a, v in n.items()))
        nums.append(n)
    correct, checks = judge.verdict(judge.worst_of(nums),
                                    cell.limits["limits"])
    res = {
        "correct": correct,
        "attempted": epochs * nbatch,
        "failed": failed,
        "metrics": {"train_cells_per_s": epochs * nbatch * M / wall,
                    "setup_s": setup_s},
        "peak": peak,
        "checks": checks,
    }
    if reading is not None:
        reading.extra.update(
            graph_stats=stats,
            batches_per_s=epochs * nbatch / wall,
            flops_per_batch=flops.step_flops(build.matmuls(cfg), M,
                                             cfg["nboot"]),
            kernel_calls=build.kernel_calls(cfg, M, xb))
        res["reading"] = reading
        res["busy_s"] = reading.busy_s
        res["window_s"] = reading.window_s
        res["breakdown"] = breakdown(reading)
    return res


def _draws(cell, seed: int, epoch: int, device) -> dict:
    cfg = cell.config
    M = int(cfg["batch_size"])
    return counts.draws(seed, epoch, int(cell.traffic["cells"]) // M, M,
                        cfg["nboot"],
                        cell.module("reference").eps_widths(cfg), device)


def _cpu_leaves(tree: dict) -> dict:
    return {k: v.detach().float().cpu() for k, v in common.leaves(tree).items()}


def _program_side(fast, params0, after, reports, before=None) -> dict:
    """What the comparison reads of the program over one checked replay:
    its reports, the parameters before (``params0``, or the unpacked
    ``before`` state) and after, the optimizer's first moment after,
    and with ``before`` the state the reference starts from."""
    q, po = after
    out = {"reports": [float(v) for v in reports.cpu()],
           "params": _cpu_leaves(fast.unpack(q)),
           "mu": _cpu_leaves(fast.unpack(po["mu"]))}
    if before is None:
        out["params0"] = params0
    else:
        qb, pb = before
        out["params0"] = _cpu_leaves(fast.unpack(qb))
        out["start"] = {"params": out["params0"],
                        "mu": _cpu_leaves(fast.unpack(pb["mu"])),
                        "nu": _cpu_leaves(fast.unpack(pb["nu"])),
                        "count": int(pb["count"])}
    return out


def _in_order(side: dict, back, D: int) -> dict:
    out = {k: (common.in_order(v, back, D) if isinstance(v, dict) else v)
           for k, v in side.items() if k != "start"}
    if "start" in side:
        st = side["start"]
        out["start"] = {k: (common.in_order(v, back, D)
                            if isinstance(v, dict) else v)
                        for k, v in st.items()}
    return out
