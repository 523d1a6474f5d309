"""The (data, model) grid of a multi-process run.

Port of ``mmvae_tpu/parallel/mesh.py`` (``make_mesh``,
``batch_sharding``, ``feature_sharded_pspecs``, ``named_tree_pspecs``,
:27-136) for one process a rank.  ``make_mesh(model_parallel=N)`` in JAX
reshapes the devices into an (n / N, N) grid with axes ``data`` and
``model``, device i at data index ``i // N`` and model index ``i % N``;
here rank r sits at the same place.  A model row is the N consecutive
ranks of one data index (on one machine, as JAX keeps its model-shard
pairs within a host); a data column is the ranks of one model index.
Every rank creates, in the same order, one process group for each model
row and one for each data column (:func:`make_mesh`).

The data axis owns rows: data index d owns the contiguous slice
``[d * M, (d + 1) * M)`` of every global batch of B rows, M = B / ndata.
The model axis owns features: model index m owns the contiguous column
block ``[m * D / N, (m + 1) * D / N)`` (:meth:`DataMesh.local_cols`), of
the counts and of every parameter axis of size D, by name
(:func:`feature_sharded_pspecs`).

Three modes, the JAX package's (README "Scaling", ``train/loop.py:91-107``):

- ``data_parallel`` (``--data_parallel``, and any multi-process run
  without ``--dp_shard``): the single-device trajectory.  Every rank
  makes the global batch's draws; each computes its rows of the report
  and of every bootstrap's resampled positions (the resampled rows are
  those of the whole batch, so the batch's counts are gathered once a
  step, :meth:`DataMesh.step_inputs`); the losses are means over rows,
  so the mean of the ranks' means is the global mean.
- ``dp_shard`` (``--dp_shard``, JAX's ``shard_map`` semantics): each
  data index draws its own noise and resamples within its own rows; only
  the report and the gradients cross the data axis.
- tensor parallel (``--tensor_parallel N``, ``model`` > 1): the data
  axis has ``dp_shard`` semantics, every model rank of one data row draws
  the same noise (JAX folds the data index alone into the key), and the
  step's D-wide work is split over the model row
  (:mod:`.collectives`).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

from .collectives import gather_rows

MODES = ("data_parallel", "dp_shard")


@dataclass(frozen=True)
class DataMesh:
    """World size, rank, device and mode of a multi-process run (one
    process a rank), with the model axis of tensor parallelism: its size
    ``model`` and this rank's groups along both axes (None where the
    axis has one rank)."""

    world: int
    rank: int
    device: torch.device
    mode: str = "data_parallel"
    model: int = 1
    model_group: object = field(default=None, compare=False, repr=False)
    data_group: object = field(default=None, compare=False, repr=False)

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"mode {self.mode!r} not in {MODES}")
        if self.model < 1 or self.world % self.model:
            raise ValueError(f"{self.world} ranks do not form a grid of "
                             f"model size {self.model}")
        if self.model > 1 and self.mode != "dp_shard":
            raise ValueError("tensor parallelism has dp_shard semantics on "
                             "its data axis")

    @property
    def shard(self) -> bool:
        """Per-data-index draws and resampling (``--dp_shard``, TP)."""
        return self.mode == "dp_shard"

    @property
    def tp(self) -> bool:
        """Whether the features are split over a model axis."""
        return self.model > 1

    @property
    def ndata(self) -> int:
        """The size of the data axis."""
        return self.world // self.model

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    def local_batch(self, B: int) -> int:
        """M = B / ndata, the rows of a global batch a data index owns."""
        if B % self.ndata:
            raise ValueError(f"--batch_size {B} not divisible by the "
                             f"{self.ndata} processes of the data axis")
        return B // self.ndata

    def rows(self, B: int) -> slice:
        """This rank's rows of a global batch of B."""
        M = self.local_batch(B)
        return slice(self.data_index * M, (self.data_index + 1) * M)

    def local_cols(self, D: int) -> slice:
        """This rank's contiguous block of the D features."""
        if D % self.model:
            raise ValueError(f"--tensor_parallel {self.model} must divide "
                             f"the feature dim {D}")
        w = D // self.model
        return slice(self.model_index * w, (self.model_index + 1) * w)

    def step_inputs(self, x: torch.Tensor, c: torch.Tensor, rand: dict):
        """(counts, covariate, draws) of a batch step's bootstrap passes.

        ``x`` and ``c`` are this rank's rows.  Under ``dp_shard`` they and
        ``rand`` (the data index's own draws) are returned as they are.
        Under ``data_parallel`` ``rand`` is the global batch's: the counts
        and covariates of the whole batch are gathered (one collective)
        and the draws cut to this rank's rows — its rows of ``rep_eps``
        and of each ``boot_eps``, and its positions of each ``ridx``,
        whose values index the whole batch."""
        if self.shard:
            return x, c, rand
        xg, cg = gather_rows([x, c])
        sl = self.rows(xg.shape[0])
        return xg, cg, {
            "rep_eps": tuple(e[sl] for e in rand["rep_eps"]),
            "ridx": rand["ridx"][:, sl],
            "boot_eps": tuple(e[:, sl] for e in rand["boot_eps"])}


def make_mesh(device: torch.device, mode: str, model: int = 1
              ) -> DataMesh | None:
    """The (data, model) grid over the process group (None for one
    process: a world of one trains the single-device step).  With
    ``model`` > 1 (dividing the world: the callers check, naming the
    flags) every rank creates the groups of every model row, then of
    every data column, in that order (``torch.distributed.new_group`` is
    collective over the whole world)."""
    if not dist.is_initialized() or dist.get_world_size() <= 1:
        return None
    world, rank = dist.get_world_size(), dist.get_rank()
    if model <= 1:
        return DataMesh(world, rank, torch.device(device), mode)
    ndata = world // model
    rows = [dist.new_group(list(range(d * model, (d + 1) * model)))
            for d in range(ndata)]
    cols = [dist.new_group(list(range(m, world, model)))
            for m in range(model)] if ndata > 1 else [None] * model
    return DataMesh(world, rank, torch.device(device), "dp_shard", model,
                    rows[rank // model], cols[rank % model])


# ----------------------------------------------------------------------
# the parameters' split over the model axis, by name
# ----------------------------------------------------------------------

def feature_sharded_pspecs(params: dict, row=(), col=(), flat=(),
                           overrides=None) -> dict:
    """Which axis of each leaf is split over the model axis (an int), or
    None for a replicated leaf — the port of JAX's name-convention
    ``feature_sharded_pspecs`` (``parallel/mesh.py:66-102``):

    - ``row``: modules whose (D, H) weight splits by rows (axis 0); their
      bias is replicated;
    - ``col``: modules whose (H, D) weight splits by columns (axis 1) and
      whose (D,) bias splits;
    - ``flat``: bare (1, D) leaves (axis 1);
    - ``overrides``: ``name -> axis`` (the mixture's (D, K) ``ln_vmf_mu``,
      axis 0), checked first.

    Everything else is replicated.  The same tree serves the parameters,
    their gradients and Adam's moments (JAX's ``named_tree_pspecs``)."""
    row, col, flat = set(row), set(col), set(flat)
    overrides = overrides or {}

    def spec_for(name, val):
        if name in overrides:
            return overrides[name]
        if name in flat:
            return 1
        if name in row:
            return {k: (0 if k == "weight" else None) for k in val}
        if name in col:
            return {k: (1 if k == "weight" else 0) for k in val}
        if isinstance(val, dict):
            return {k: None for k in val}
        return None

    return {k: spec_for(k, v) for k, v in params.items()}


def _map(tree, specs, fn):
    if isinstance(tree, dict):
        return {k: _map(v, specs[k], fn) for k, v in tree.items()}
    return fn(tree, specs)


def shard_params(tree: dict, specs: dict, mesh: DataMesh,
                 device=None) -> dict:
    """This rank's shard of a full parameter tree (numpy, or tensors as
    ``params_from_numpy`` gives them): each split leaf cut to the rank's
    block of its split axis; tensors on ``device`` (default the leaf's
    own).  Also Adam's moment trees, which mirror the parameters."""

    def cut(leaf, axis):
        if axis is not None:
            sl = [slice(None)] * np.ndim(leaf)
            sl[axis] = mesh.local_cols(np.shape(leaf)[axis])
            leaf = leaf[tuple(sl)]
        if isinstance(leaf, torch.Tensor):
            return leaf.contiguous().to(device or leaf.device)
        return np.ascontiguousarray(leaf)

    return _map(tree, specs, cut)


def gather_params(tree: dict, specs: dict, mesh: DataMesh) -> dict:
    """The full tree from every rank's shard: each split leaf all-gathered
    over the model row and concatenated along its axis in model order
    (one ``all_gather`` a leaf); replicated leaves as they are.  Every
    rank of the row must call it."""

    def join(leaf, axis):
        if axis is None or mesh.model_group is None:
            return leaf
        parts = [torch.empty_like(leaf) for _ in range(mesh.model)]
        dist.all_gather(parts, leaf.contiguous(), group=mesh.model_group)
        return torch.cat(parts, dim=axis)

    return _map(tree, specs, join)

