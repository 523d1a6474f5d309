"""Data-parallel and multi-process training over ``torch.distributed``
(port of ``mmvae_tpu/parallel``: one process a rank, the data axis only).

- :mod:`.multihost`: start-up at a coordinator, the backend rule, the
  per-rank batch schedule, the gather of each rank's rows to rank 0;
- :mod:`.mesh`: :class:`~.mesh.DataMesh`, the world, this rank, its
  device, its rows of a batch, and the two modes' step inputs;
- :mod:`.collectives`: the step's ``pmean`` and row gather, one
  collective a call, bitwise equal on every rank.
"""

from .mesh import DataMesh, make_mesh

__all__ = ["DataMesh", "make_mesh"]
