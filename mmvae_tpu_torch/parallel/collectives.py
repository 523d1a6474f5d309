"""The collectives of a batch step, data parallel and tensor parallel.

Port of the ``pmean`` reductions of the JAX package's ``shard_map`` steps
(``ops/nb_fast.py:299-323``, ``train/loop.py:291-319``), of the batch
gather its SPMD partitioner inserts under ``--data_parallel``, and of
``mmvae_tpu/parallel/collectives.py`` (:17-82), the tensor-parallel
collectives with their own backward passes:

- :func:`psum_id_grad`: a sum over the model row forward, the identity
  backward (partial products summed into a replicated activation whose
  cotangent is replicated);
- :func:`psum_grad`: the identity forward, a sum backward (a replicated
  activation entering shard-local compute, whose cotangents are
  partial);
- :func:`tp_l2_normalize`: L2 normalization over a split axis; the
  square sums are summed, and so are the cotangents of that total.

``torch.distributed.nn.functional.all_reduce`` sums in its backward pass,
which is right for :func:`tp_l2_normalize`'s total and wrong where JAX
uses ``psum_id_grad``: it would multiply those gradients by the model
axis's size.  Each collective here is its own ``torch.autograd.Function``.
A ``group`` of None is an axis of one rank: every function is then the
identity.

Each function is ONE collective a call: a list of tensors travels in one
flat buffer.  The three calls that reach ``torch.distributed``
(:func:`psum`, through which :func:`pmax` and the autograd Functions
go, :func:`pmean` and :func:`gather_rows`) go through :func:`_issue`,
which follows the rule of :func:`capture_form` inside a CUDA graph
capture of the superbatch step (``train/superbatch.py``): an NCCL call
is recorded in the graph, a gloo call on a card becomes a host step
between two segment graphs (:func:`segmented`), and a capture that
meets a gloo call with no segmented capture open raises.

Both backends reduce each element once and send every rank the same
result, so the ranks hold the same bits, and a fixed world on fixed
devices repeats them from run to run (tests/test_torch_parallel.py and
tests/test_torch_tp_*.py check both on gloo, ``chip_smoke.py`` phases
37, 39 and 44 on gloo, or on NCCL where the machine has two cards).
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

#: the superbatch step's forms (:func:`capture_form`)
FORMS = ("graph", "segments", "eager")


def capture_form(backend: str | None, device_type: str) -> str:
    """How S batch steps run as one superbatch on ``device_type`` when
    their collectives go over ``backend`` (None: one process, no
    collective): ``"eager"`` off a card (the body runs as it is);
    ``"graph"`` on a card with NCCL or no collective (one CUDA graph,
    NCCL's kernels recorded in it: NCCL supports stream capture);
    ``"segments"`` on a card with gloo, which reduces on the host after
    a device-to-host copy and so cannot be captured: each collective
    ends the running segment's capture, runs between two segment graphs
    as a host step, and the next segment's capture begins after it."""
    if device_type != "cuda":
        return "eager"
    if backend is None or backend == "nccl":
        return "graph"
    if backend == "gloo":
        return "segments"
    raise ValueError(f"no superbatch form for backend {backend!r}")


_segments = None  # the segmented capture in progress (:func:`segmented`)


@contextlib.contextmanager
def segmented(capture):
    """Hand every gloo collective issued under a capture to
    ``capture.host_step(call)`` while the block runs (the autograd
    engine's device thread included)."""
    global _segments
    _segments = capture
    try:
        yield
    finally:
        _segments = None


def _issue(name: str, tensor: torch.Tensor, *args, **kw) -> None:
    """``torch.distributed.<name>(*args, **kw)`` in the form
    :func:`capture_form` gives: issued as it is eagerly, on the CPU and
    under an NCCL capture; a host step of the segmented capture under a
    gloo capture on a card (the call is looked up when the step runs, and
    its tensors stay alive with the step).  ``tensor`` is the call's
    input, ``kw["group"]`` its group."""
    if tensor.is_cuda and torch.cuda.is_current_stream_capturing() and (
            capture_form(dist.get_backend(kw.get("group")), "cuda")
            == "segments"):
        if _segments is None:
            raise RuntimeError(
                f"a gloo {name} inside a CUDA graph capture: gloo reduces on "
                "the host, so only a segmented capture "
                "(train.superbatch.SuperbatchGraphs) can hold it")
        _segments.host_step(lambda: getattr(dist, name)(*args, **kw))
        return
    getattr(dist, name)(*args, **kw)


def _flat(tensors):
    return torch.cat([t.reshape(-1) for t in tensors])


def _split(flat, like):
    out, off = [], 0
    for t in like:
        out.append(flat[off:off + t.numel()].view(t.shape))
        off += t.numel()
    return out


def psum(tensors: list[torch.Tensor], group=None, op=dist.ReduceOp.SUM
         ) -> list[torch.Tensor]:
    """The sum (or ``op``) over ``group`` of each float32 tensor, from one
    ``all_reduce`` of their flat concatenation (no autograd)."""
    if group is None:
        return list(tensors)
    flat = _flat(tensors)
    _issue("all_reduce", flat, flat, op=op, group=group)
    return _split(flat, tensors)


def pmax(t: torch.Tensor, group=None) -> torch.Tensor:
    """The elementwise maximum over ``group`` (``lax.pmax``)."""
    return psum([t], group, dist.ReduceOp.MAX)[0]


def pmean(tensors: list[torch.Tensor], group=None) -> list[torch.Tensor]:
    """The mean over the ranks of ``group`` (default the world) of each
    tensor (float32, any shapes), from one ``all_reduce`` of their flat
    concatenation."""
    flat = _flat(tensors)
    _issue("all_reduce", flat, flat, group=group)
    flat = flat / dist.get_world_size(group)
    return _split(flat, tensors)


class _PsumIdGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *xs):
        return tuple(psum([x.detach() for x in xs], group))

    @staticmethod
    def backward(ctx, *gs):
        return (None, *gs)


class _PsumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, x):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return None, psum([g.contiguous()], ctx.group)[0]


class _PsumSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, x):
        ctx.group = group
        return psum([x.detach()], group)[0]

    @staticmethod
    def backward(ctx, g):
        return None, psum([g.contiguous()], ctx.group)[0]


def psum_id_grad(xs, group=None):
    """``lax.psum`` over ``group`` whose backward is the identity; ``xs``
    a tensor or a list of tensors (one collective for the list)."""
    if group is None:
        return xs
    if isinstance(xs, torch.Tensor):
        return _PsumIdGrad.apply(group, xs)[0]
    return list(_PsumIdGrad.apply(group, *xs))


def psum_grad(x: torch.Tensor, group=None) -> torch.Tensor:
    """Identity forward; the cotangent summed over ``group`` backward."""
    if group is None:
        return x
    return _PsumGrad.apply(group, x)


def tp_l2_normalize(x: torch.Tensor, group=None, dim: int = -1
                    ) -> torch.Tensor:
    """L2 normalization over ``dim``, split over ``group``: the local
    square sums are summed into the global norm (a plain sum, whose
    backward sums too); eps as ``ops.losses.l2_normalize`` (p = 2,
    1e-12)."""
    sq = torch.sum(x * x, dim=dim, keepdim=True)
    tot = sq if group is None else _PsumSum.apply(group, sq)
    return x / torch.clamp_min(torch.sqrt(tot), 1e-12)


def gather_rows(tensors: list[torch.Tensor], group=None
                ) -> list[torch.Tensor]:
    """Every rank's rows of each (M, ...) tensor, concatenated in rank
    order over ``group`` (default the world): (ranks * M, ...) with each
    tensor's dtype.  The tensors ride one ``all_gather`` as raw bytes, so
    narrow counts (int8, int16) move in their storage width whatever
    dtypes the backend reduces."""
    M = tensors[0].shape[0]
    views = [t.contiguous().view(torch.uint8).reshape(M, -1)
             for t in tensors]
    widths = [v.shape[1] for v in views]
    flat = torch.cat(views, dim=1)
    parts = [torch.empty_like(flat)
             for _ in range(dist.get_world_size(group))]
    _issue("all_gather", flat, parts, flat, group=group)
    full = torch.cat(parts, dim=0)
    out, off = [], 0
    for t, w in zip(tensors, widths):
        out.append(full[:, off:off + w].contiguous().view(t.dtype)
                   .reshape(full.shape[0], *t.shape[1:]))
        off += w
    return out
