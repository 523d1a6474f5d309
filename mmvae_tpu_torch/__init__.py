"""mmvae_tpu_torch — the PyTorch/CUDA port of ``mmvae_tpu`` for NVIDIA
Hopper (H100).

The JAX package ``mmvae_tpu`` stays the reference; this package mirrors
its module names so each counterpart is easy to find, imports ``torch``
and never ``jax``, and shares the JAX-free host layer
(``mmvae_tpu.io``, ``mmvae_tpu.data.block``, ``mmvae_tpu.data.pipeline``,
``mmvae_tpu.utils.logging``) instead of copying it.

Ported so far: the NB serving path (``python -m
mmvae_tpu_torch.cli.encode --model nb``) and NB training with the
default architecture (``python -m mmvae_tpu_torch.cli.nb_vae``), on six
hand-written CUDA kernels in ``csrc/``: the count encoder's forward and
backward and the fused step's ``lse``, ``value``, ``valgrad`` and
``finish``.
"""

__version__ = "0.1.0"
