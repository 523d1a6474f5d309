"""The superbatch step as CUDA graphs: S batch steps a replay.

Port of the JAX trainer's compiled superbatch step
(``mmvae_tpu/train/loop.py``: ``Trainer._superbatch_step`` :341 and
``_superbatch_step_fast`` :373, the ``lax.scan`` of S batch steps in one
jitted dispatch, and ``_record_outputs`` :64, the recording variant's
posteriors as scan outputs).  In PyTorch the counterpart of a program
dispatched once per S batches is a CUDA graph of S batch steps, replayed
once per S batches.

:class:`SuperbatchGraphs` owns the static buffers of one step object (a
packed step or the generic ``Trainer``): the state (parameters and Adam
state), the KL weight beta, an (S, B, D) superbatch of counts in their
narrow dtype, an (S, B, C) covariate, the S batches' slices of the
epoch's draws, and the outputs (the S reports and, on a recording
superbatch, the S batches' record outputs).  Before a replay the caller
fills the inputs by a few copies; the graph runs the step's
``superbatch_step`` on the static state, writes the reports and record
outputs into their buffers, and ends by copying the final state into the
static state, where the next replay starts.

On a CUDA device each (superbatch size, record?) pair is captured once
(the last superbatch of an epoch may be shorter) and reused for every
later superbatch and epoch, all graphs in one memory pool.  Before its
capture the body runs once on the capture stream (the warm-up: every
kernel instance built and first called, cuBLAS's workspace for that
stream made, the recorder's and the mixture's device constants made,
and under a mesh every collective issued once, which makes NCCL's
communicators: they cannot be made under capture), and the static
state is then restored, so the warm-up changes no result.  A capture
or replay that fails raises; nothing falls back to the per-batch path.

Under a :class:`~mmvae_tpu_torch.parallel.mesh.DataMesh` the body is
the steps' ``batch_step(mesh=...)`` (JAX's scan body with
``axis_name``), and its collectives decide the form
(``parallel.collectives.capture_form``, by backend and device type):

- ``"graph"`` (one process, or NCCL): one CUDA graph a (size, record?),
  NCCL's kernels recorded in it, on the stream the capture began on;
- ``"segments"`` (gloo on a card, which reduces on the host): the graph
  of a (size, record?) is an ordered chain of segment graphs, all in
  the one pool, with a host collective between two of them.  Each
  collective the body issues under capture (a backward pass's on the
  autograd engine's device thread too) ends the running segment, is
  kept with its tensors as a host step, and the next segment begins;
  the segments are captured in CUDA's relaxed mode, since a segment may
  begin on one thread and end on another.  A replay runs the chain in
  order;
- ``"eager"`` (the CPU): the body runs as it is, collectives included.

Every rank must capture the same (size, record?) keys in the same
order, since a capture issues no collective and a warm-up issues them
all: the global schedule gives every rank the same number of batches,
so the same superbatch sizes, and the recording epochs are the same
epochs on every rank.

The kernel wrappers count launches as Python calls, so a capture would
count its launches once and a replay not at all: each graph (each
segment) keeps the counts its capture made, they are taken back after
the capture, and every replay adds them.  The warm-up's launches are
real and stay counted (``warm_launches`` keeps them apart).

Timing, always on: between :meth:`SuperbatchGraphs.begin_epoch` and
:meth:`~SuperbatchGraphs.end_epoch` (the epoch runner's first and last
steps) each replay (each chain) lies between a pair of timing CUDA
events on the current stream, from a pool the object reuses; the host
clock stands in on the CPU.  Their times are read only once the card
has passed them: in the next epoch, once its first replay is enqueued
(after the caller's loss fetch, and while the card runs that replay),
or in :meth:`~SuperbatchGraphs.close`, so timing adds no
synchronization and no idle time; an epoch whose events are still
pending then is dropped and counted (``stats["rows_dropped"]``).  Each read epoch is a
row of ``stats["epochs"]``.  The loop's host phases are
:func:`~mmvae_tpu_torch.utils.profiling.annotate` spans, which cost
nothing unless a torch profiler runs."""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

from ..ops.losses import kl_weight_schedule
from ..ops.nb_fast import tree_leaves
from ..parallel.collectives import capture_form, segmented
from ..utils.profiling import annotate


def tree_map(fn, tree):
    """``fn`` of every tensor leaf of nested dicts, tuples and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_zip(fn, a, b) -> None:
    """``fn(leaf of a, leaf of b)`` over two trees of one structure."""
    if isinstance(a, dict):
        for k in a:
            tree_zip(fn, a[k], b[k])
    elif isinstance(a, (tuple, list)):
        for x, y in zip(a, b):
            tree_zip(fn, x, y)
    else:
        fn(a, b)


def tree_copy_(dst, src) -> None:
    """Copy every leaf of ``src`` into the same leaf of ``dst``."""
    tree_zip(lambda d, t: d.copy_(t), dst, src)


def clone_tree(tree):
    return tree_map(lambda t: t.detach().clone(), tree)


def tree_like(template, tree):
    """``tree``'s leaves in nested dicts ordered as ``template``'s keys
    (the same tensors: only the dicts' order changes)."""
    if isinstance(template, dict):
        return {k: tree_like(template[k], tree[k]) for k in template}
    return tree


def launch_counters() -> dict:
    """``{name: (wrapper, attribute)}`` of every launch counter of the
    training steps' kernel wrappers and of the packed steps' gradient
    assembly (``ops.nb_fast.pack_grad``)."""
    from ..ops import enc_kernel as enc
    from ..ops import nb_elbo as ne
    from ..ops import nb_fast as nf
    from ..ops import nb_step as ns

    out = {}
    for fn in (enc.count_encode, enc.count_encode_bwd, ns.lse, ns.value,
               ns.valgrad, ns.finish, ne.elbo_fwd, ne.elbo_bwd,
               nf.pack_grad):
        for attr in sorted(vars(fn)):
            if attr.endswith("launches"):
                out[f"{fn.__name__}.{attr}"] = (fn, attr)
    return out


def read_counts() -> dict:
    return {k: getattr(w, a) for k, (w, a) in launch_counters().items()}


def add_counts(delta: dict, sign: int = 1) -> None:
    for k, (w, a) in launch_counters().items():
        if delta.get(k):
            setattr(w, a, getattr(w, a) + sign * delta[k])


def count_delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def superbatch_form(mesh, device) -> str:
    """``"graph"``, ``"segments"`` or ``"eager"``: the form of a run on
    ``device`` under ``mesh`` (None: one process), by the rule of
    ``parallel.collectives.capture_form`` with the mesh's backend."""
    dev = torch.device(device)
    backend = (None if mesh is None or dev.type != "cuda"
               else dist.get_backend())
    return capture_form(backend, dev.type)


class _HostEvent:
    """``torch.cuda.Event``'s timing surface on the host's clock, for the
    eager form, whose work is done when its call returns."""

    t = 0.0

    def record(self, stream=None) -> None:
        self.t = time.perf_counter()

    def query(self) -> bool:
        return True

    def elapsed_time(self, end: "_HostEvent") -> float:
        return 1e3 * (end.t - self.t)


class _Segments:
    """The chain of one (size, record?) under gloo on a card: segment
    graphs and host collectives, in order, as ``(graph, launch counts)``
    and ``(call, None)`` (the module docstring)."""

    def __init__(self, pool):
        self.pool, self.steps = pool, []
        self.graph = self.before = None

    def begin(self) -> None:
        self.graph, self.before = torch.cuda.CUDAGraph(), read_counts()
        self.graph.capture_begin(pool=self.pool, capture_error_mode="relaxed")

    def end(self) -> None:
        graph, self.graph = self.graph, None
        graph.capture_end()
        delta = count_delta(read_counts(), self.before)
        add_counts(delta, -1)  # the capture launched nothing
        self.steps.append((graph, delta))

    def host_step(self, call) -> None:
        """``collectives.segmented``'s hook: a collective met under
        capture."""
        self.end()
        self.steps.append((call, None))
        self.begin()

    def abort(self) -> None:
        """End a capture a failure left open (its graph is dropped)."""
        if self.graph is not None:
            graph, self.graph = self.graph, None
            try:
                graph.capture_end()
            except RuntimeError:
                pass


class SuperbatchGraphs:
    """Static buffers and graphs of ``step``'s superbatch step at up to
    ``S`` batches (see the module docstring).  ``record_fn(params, x)``
    is the recorder's encode, evaluated after each batch's updates on a
    recording superbatch; ``covar_dim`` the width of the all-ones
    covariate that :meth:`fill` keeps when given no covariate; ``mesh``
    the :class:`~mmvae_tpu_torch.parallel.mesh.DataMesh` of every batch
    step (None: one process), whose backend and the device choose the
    form.

    Use: :meth:`set_state` and :meth:`set_epoch` once per epoch,
    :meth:`fill` then :meth:`run` per superbatch, :meth:`state` for
    copies of the state, :meth:`close` to free the graphs; the epoch
    runner brackets each epoch by :meth:`begin_epoch` and
    :meth:`end_epoch`.  ``stats`` holds the form, the captures, their
    seconds (``capture_s``, the sum of ``capture_warm_s``, each capture's
    warm-up superbatch and state restore, and ``capture_graph_s``, the
    cache emptied, the capture and its instantiation), the device memory
    the captures reserved (the graphs' pool), the replays, the segments
    and host collectives a superbatch of the largest training superbatch
    captured (``segments_of`` batches; 1 and 0 for a whole graph), and
    the epochs' rows (``epochs``; ``rows_dropped``): each row's
    ``epoch``, ``replays``, ``batches``, ``replay_s`` (the replays'
    device seconds; a graph's first replay uploads it), ``span_s`` (the
    device seconds from the epoch's start to its end) and ``lead_s``
    (from the previous epoch's end to this start, the card's time across
    the epoch boundary; None on the first epoch)."""

    def __init__(self, step, S: int, record_fn=None, covar_dim: int = 1,
                 mesh=None):
        if S < 1:
            raise ValueError(f"superbatch size {S} < 1")
        self.step, self.S, self.record_fn = step, int(S), record_fn
        self.covar_dim, self.mesh = covar_dim, mesh
        self.q = self.po = self.beta = self.epoch = None
        self.x = self.c = self.rand = self.reps = self.enc = None
        self.graphs: dict = {}
        self.pool = self.stream = None
        self.warm_launches: dict = {}
        # timing events: the free pool, the epoch in progress, the ended
        # epoch not read yet, and the last ended epoch's end
        self._events: list = []
        self._epoch = self._unread = self._last_end = None
        self._timing_dev = None
        self.stats = {"form": None, "captures": 0, "capture_s": 0.0,
                      "capture_warm_s": 0.0, "capture_graph_s": 0.0,
                      "pool_bytes": 0, "replays": 0, "segments": 0,
                      "host_collectives": 0, "segments_of": 0,
                      "epochs": [], "rows_dropped": 0}

    @property
    def form(self) -> str:
        """:func:`superbatch_form` for the state's device."""
        if self.stats["form"] is None:
            self.stats["form"] = superbatch_form(self.mesh, self._device())
        return self.stats["form"]

    # ------------------------------------------------------------------
    # inputs and state
    # ------------------------------------------------------------------
    def set_state(self, q, po) -> None:
        """Copy the packed state and Adam state into the static state
        (allocated at the first call)."""
        if self.q is None:
            self.q, self.po = clone_tree(q), clone_tree(po)
        else:
            tree_copy_(self.q, q)
            tree_copy_(self.po, po)

    def state(self):
        """Copies of the static state: the next replay overwrites it."""
        return clone_tree(self.q), clone_tree(self.po)

    def set_epoch(self, epoch: int) -> None:
        """The epoch of the next runs, and its KL weight, made on the
        host as the per-batch path makes it, into the static buffer."""
        if self.beta is None:
            self.beta = torch.empty((), dtype=torch.float32,
                                    device=self._device())
        self.epoch = float(epoch)
        st = self.step
        self.beta.copy_(kl_weight_schedule(self.epoch, st.kl_max, st.kl_min,
                                           st.kl_discount))

    def _device(self):
        return tree_leaves(self.q)[0].device

    # ------------------------------------------------------------------
    # epoch timing
    # ------------------------------------------------------------------
    def _mark(self):
        """A timing event from the pool, recorded now on the timing
        device's current stream (the host clock on the CPU)."""
        dev = self._timing_dev
        cuda = dev.type == "cuda"
        if self._events:
            ev = self._events.pop()
        else:
            ev = torch.cuda.Event(enable_timing=True) if cuda else _HostEvent()
        ev.record(torch.cuda.current_stream(dev) if cuda else None)
        return ev

    def begin_epoch(self, epoch: int, device) -> None:
        """Mark this epoch's start on ``device``: the replays :meth:`run`
        makes until :meth:`end_epoch` are this epoch's.  The last ended
        epoch is read into its row after this epoch's first replay."""
        self._timing_dev = torch.device(device)
        self._epoch = {"epoch": epoch, "start": self._mark(),
                       "prev": self._last_end, "pairs": [], "batches": 0}

    def end_epoch(self) -> None:
        """Mark the end of the epoch :meth:`begin_epoch` started; its
        row is read after the next epoch's first replay or in
        :meth:`close`."""
        ep, self._epoch = self._epoch, None
        ep["end"] = self._last_end = self._mark()
        self._settle()  # an epoch that ran no replay
        self._unread = ep

    def _release(self, ep: dict) -> None:
        """Return an epoch's events to the pool, but its end, which the
        next epoch reads as its ``prev``."""
        self._events.append(ep["start"])
        for pair in ep["pairs"]:
            self._events.extend(pair)
        if ep["prev"] is not None:
            self._events.append(ep["prev"])

    def _settle(self) -> None:
        """The ended epoch's row, if the card has passed all its events;
        otherwise the epoch is dropped.  Never waits."""
        ep, self._unread = self._unread, None
        if ep is None:
            return
        # an epoch's events (and its prev) lie in order on one stream:
        # once the card has passed its end, it has passed them all
        if not ep["end"].query():
            self.stats["rows_dropped"] += 1
            self._release(ep)
            return
        self.stats["epochs"].append({
            "epoch": ep["epoch"], "replays": len(ep["pairs"]),
            "batches": ep["batches"],
            "replay_s": sum(a.elapsed_time(b) for a, b in ep["pairs"]) / 1e3,
            "span_s": ep["start"].elapsed_time(ep["end"]) / 1e3,
            "lead_s": (None if ep["prev"] is None
                       else ep["prev"].elapsed_time(ep["start"]) / 1e3)})
        self._release(ep)

    def _alloc(self, x0: torch.Tensor, c0, rand) -> None:
        S, dev = self.S, self._device()
        self.x = torch.empty((S, *x0.shape[-2:]), dtype=x0.dtype,
                             device=dev)
        B = x0.shape[-2]
        C = self.covar_dim if c0 is None else c0.shape[-1]
        self.c = torch.ones((S, B, C), dtype=torch.float32, device=dev)
        self.rand = tree_map(lambda t: torch.empty(
            (S, *t.shape[1:]), dtype=t.dtype, device=dev), rand)
        self.reps = torch.empty((S,), dtype=torch.float32, device=dev)

    @staticmethod
    def _put(buf: torch.Tensor, src) -> None:
        """``src`` (an (s, ...) tensor, on the device or on the host, or
        a sequence of s tensors) into the first s rows of ``buf``."""
        if isinstance(src, torch.Tensor):
            if src.dtype != buf.dtype:
                raise TypeError(f"superbatch input {src.dtype}, buffer "
                                f"{buf.dtype}")
            buf[:src.shape[0]].copy_(src, non_blocking=src.is_pinned())
            return
        for j, t in enumerate(src):
            if t.dtype != buf.dtype:
                raise TypeError(f"superbatch input {t.dtype}, buffer "
                                f"{buf.dtype}")
            buf[j].copy_(t)

    def fill(self, xs, cs, rand) -> int:
        """Copy one superbatch into the static inputs: ``xs`` its s
        count batches ((s, B, D) or s tensors of (B, D)), ``cs`` their
        covariate rows (None: the all-ones covariate), ``rand`` the s
        batches' draws (leading axis s).  Returns s."""
        s = len(xs)
        if not 1 <= s <= self.S:
            raise ValueError(f"superbatch of {s} batches (S = {self.S})")
        with annotate("superbatch.fill"):
            if self.x is None:
                self._alloc(xs[0], None if cs is None else cs[0], rand)
            self._put(self.x, xs)
            if cs is not None:
                self._put(self.c, cs)
            tree_zip(lambda b, t: b[:s].copy_(t), self.rand, rand)
        return s

    # ------------------------------------------------------------------
    # the body and its graphs
    # ------------------------------------------------------------------
    def _body(self, s: int, record: bool) -> None:
        rand = tree_map(lambda t: t[:s], self.rand)
        q, po, reps, enc = self.step.superbatch_step(
            self.q, self.po, self.x[:s], self.c[:s], self.epoch, self.beta,
            rand, self.record_fn if record else None, mesh=self.mesh)
        self.reps[:s].copy_(reps)
        if record:
            if self.enc is None:
                # the warm-up (or the CPU's first run) allocates them,
                # never a capture
                self.enc = tuple(torch.empty((self.S, *t.shape[1:]),
                                             dtype=t.dtype, device=t.device)
                                 for t in enc)
            for e, t in zip(self.enc, enc):
                e[:s].copy_(t)
        tree_copy_(self.q, q)
        tree_copy_(self.po, po)
        # the state leaves as the step leaves it: in its dicts' order
        self.q, self.po = tree_like(q, self.q), tree_like(po, self.po)

    def _capture(self, s: int, record: bool) -> None:
        dev = self.x.device
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        with annotate("superbatch.capture.warm"):
            if self.stream is None:
                self.stream = torch.cuda.Stream(dev)
                self.pool = torch.cuda.graph_pool_handle()
            cur = torch.cuda.current_stream(dev)
            saved = self.state()
            before = read_counts()
            self.stream.wait_stream(cur)
            with torch.cuda.stream(self.stream):
                self._body(s, record)
            cur.wait_stream(self.stream)
            for k, n in count_delta(read_counts(), before).items():
                self.warm_launches[k] = self.warm_launches.get(k, 0) + n
            # the warm-up ran a real superbatch: put the state back
            self.set_state(*saved)
            del saved
            torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        with annotate("superbatch.capture.graph"):
            # the pool grows by what this capture needs beyond the blocks
            # the graphs captured before it freed (the capture empties the
            # cache first, as done here, so the growth is the pool's alone)
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(dev)
            if self.form == "segments":
                chain = self._capture_segments(s, record)
            else:
                graph = torch.cuda.CUDAGraph()
                before = read_counts()
                # under a mesh (NCCL) only this thread is held to
                # capture's rules: NCCL's watchdog thread queries its
                # events meanwhile
                with torch.cuda.graph(graph, pool=self.pool,
                                      stream=self.stream,
                                      capture_error_mode=(
                                          "global" if self.mesh is None
                                          else "thread_local")):
                    self._body(s, record)
                delta = count_delta(read_counts(), before)
                add_counts(delta, -1)  # the capture launched nothing
                chain = [(graph, delta)]
            torch.cuda.synchronize(dev)
        t2 = time.perf_counter()
        self.graphs[(s, record)] = chain
        st = self.stats
        nseg = sum(d is not None for _, d in chain)
        if not record and s >= st["segments_of"]:
            st.update(segments=nseg, host_collectives=len(chain) - nseg,
                      segments_of=s)
        st["captures"] += 1
        st["capture_warm_s"] += t1 - t0
        st["capture_graph_s"] += t2 - t1
        st["capture_s"] += (t1 - t0) + (t2 - t1)
        st["pool_bytes"] += torch.cuda.memory_reserved(dev) - reserved

    def _capture_segments(self, s: int, record: bool) -> list:
        """The segmented capture of one (s, record): the chain."""
        seg = _Segments(self.pool)
        with torch.cuda.stream(self.stream), segmented(seg):
            seg.begin()
            try:
                self._body(s, record)
                seg.end()
            except BaseException:
                seg.abort()
                raise
        return seg.steps

    def run(self, s: int, record: bool = False):
        """The superbatch step on the static inputs' first ``s`` batches:
        on a CUDA device a graph replay, or the chain of segment replays
        and host collectives (captured at the first call of each (s,
        record)), the body itself on the CPU.  Returns views of the
        static outputs, (reports (s,), record outputs (s, B, width) or
        None), valid until the next run."""
        if record and self.record_fn is None:
            raise ValueError("a recording superbatch needs a record_fn")
        eager = self.form == "eager"
        if not eager and (s, record) not in self.graphs:
            self._capture(s, record)
        ep = self._epoch
        with annotate("superbatch.replay"):
            start = None if ep is None else self._mark()
            if eager:
                self._body(s, record)
            else:
                for step, delta in self.graphs[(s, record)]:
                    if delta is None:
                        step()  # a host collective
                    else:
                        step.replay()
                        add_counts(delta)
                self.stats["replays"] += 1
            if ep is not None:
                ep["pairs"].append((start, self._mark()))
                ep["batches"] += s
        if ep is not None:
            self._settle()  # the last epoch's row, the card busy meanwhile
        enc = (tuple(e[:s] for e in self.enc) if record else None)
        return self.reps[:s], enc

    def close(self) -> None:
        """Free the graphs and their pool (the static buffers go with
        this object).  A graph must not outlive a device tensor it reads
        that is not one of its static buffers (the mixture's masks, the
        recorder's noise): free the graphs before those change."""
        if self.graphs:
            torch.cuda.synchronize(self.x.device)
        self._settle()
        self.graphs.clear()
        self.pool = self.stream = None
        self._events, self._epoch, self._last_end = [], None, None

