"""Measurement scripts of the port, run on the card as modules:
``python -m mmvae_tpu_torch.benchmarks.valgrad_roofline`` (the roofline
probe P1 and K2's op-mix bracket) and ``python -m
mmvae_tpu_torch.benchmarks.trace_step`` (per-kernel device time of the
packed training step).  Importing them has no side effects."""
