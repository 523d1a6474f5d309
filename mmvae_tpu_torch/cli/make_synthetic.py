"""``make_synthetic`` — synthetic count matrices for tests and benchmarks.

The generator is host-only numpy, shared with the JAX package rather
than copied (``mmvae_tpu.cli.make_synthetic`` loads no JAX):

    python -m mmvae_tpu_torch.cli.make_synthetic --out data.mtx.gz \
        --genes 20000 --cells 4000 --index
"""

from __future__ import annotations

import sys

from mmvae_tpu.cli.make_synthetic import main

__all__ = ["main"]

if __name__ == "__main__":
    sys.exit(main())
