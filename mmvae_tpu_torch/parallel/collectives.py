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
flat buffer.  Both backends reduce each element once and send every rank
the same result, so the ranks hold the same bits, and a fixed world on
fixed devices repeats them from run to run (tests/test_torch_parallel.py
and tests/test_torch_tp_*.py check both on gloo, ``chip_smoke.py``
phases 37 and 39 on gloo, or on NCCL where the machine has two cards).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


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
    dist.all_reduce(flat, op=op, group=group)
    return _split(flat, tensors)


def pmax(t: torch.Tensor, group=None) -> torch.Tensor:
    """The elementwise maximum over ``group`` (``lax.pmax``)."""
    return psum([t], group, dist.ReduceOp.MAX)[0]


def pmean(tensors: list[torch.Tensor], group=None) -> list[torch.Tensor]:
    """The mean over the ranks of ``group`` (default the world) of each
    tensor (float32, any shapes), from one ``all_reduce`` of their flat
    concatenation."""
    flat = _flat(tensors)
    dist.all_reduce(flat, group=group)
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
    dist.all_gather(parts, flat, group=group)
    full = torch.cat(parts, dim=0)
    out, off = [], 0
    for t, w in zip(tensors, widths):
        out.append(full[:, off:off + w].contiguous().view(t.dtype)
                   .reshape(full.shape[0], *t.shape[1:]))
        off += w
    return out
