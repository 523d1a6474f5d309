"""Data-parallel, tensor-parallel and multi-process training over
``torch.distributed`` (port of ``mmvae_tpu/parallel``: one process a
rank, on a (data, model) grid).

- :mod:`.multihost`: start-up at a coordinator, the backend rule, the
  per-rank batch schedule, the gather of each rank's rows to rank 0;
- :mod:`.mesh`: :class:`~.mesh.DataMesh`, the world, this rank, its
  device, its rows of a batch and its block of the features, the two
  data modes' step inputs, and the parameters' split by name
  (``feature_sharded_pspecs``, ``shard_params``, ``gather_params``);
- :mod:`.collectives`: the step's ``pmean`` and row gather, and the
  tensor-parallel sums with their own backward passes, one collective a
  call, bitwise equal on every rank.
"""

from .mesh import DataMesh, make_mesh

__all__ = ["DataMesh", "make_mesh"]
