"""mmvae_tpu_torch — the PyTorch/CUDA port of ``mmvae_tpu`` for NVIDIA
Hopper (H100).

The JAX package ``mmvae_tpu`` stays the reference; this package mirrors
its module names so each counterpart is easy to find, imports ``torch``
and never ``jax``, and imports nothing of ``mmvae_tpu``.  It keeps its
own copy of the host layer it needs (``io``, ``data.block``,
``data.pipeline``, ``utils.logging``, ``utils.metrics``,
``cli.make_synthetic``), so the files both packages write stay
byte-compatible without either importing the other.

Ported so far: the NB model (serving with ``python -m
mmvae_tpu_torch.cli.encode --model nb``, training with ``python -m
mmvae_tpu_torch.cli.nb_vae``) and the joint vMF+NB model (``python -m
mmvae_tpu_torch.cli.vmfnb_vae``, ``encode --model vmfnb``), default
architectures, on hand-written CUDA kernels in ``csrc/``: the count
encoder's forward (with the row-norm stats variant) and backward, and
the fused NB step's ``lse``, ``value``, ``valgrad`` and ``finish``
(with the joint model's post-softmax bias / exp-nu variants).
"""

__version__ = "0.1.0"
