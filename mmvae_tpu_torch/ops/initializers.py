"""Parameter initialization matching LibTorch's ``nn.Linear`` defaults.

Port of ``mmvae_tpu/ops/initializers.py``: U(-1/sqrt(fan_in),
+1/sqrt(fan_in)) for the weight and the bias.  Weights are stored
(fan_in, fan_out), the JAX package's layout, so parameters and
checkpoints carry over between the two packages unchanged.  The numbers
come from a ``torch.Generator``, so they differ from the JAX package's
for the same seed; parity tests hand both packages the same numpy draws.
"""

from __future__ import annotations

import math

import torch


def torch_linear_init(generator: torch.Generator, d_in: int, d_out: int,
                      with_bias: bool = True,
                      device: torch.device | str = "cpu") -> dict:
    """{'weight': (d_in, d_out), 'bias': (d_out,)} with LibTorch init."""
    bound = 1.0 / math.sqrt(d_in)

    def uniform(*shape):
        u = torch.rand(shape, generator=generator, dtype=torch.float32,
                       device=generator.device)
        return (u * (2.0 * bound) - bound).to(device)

    params = {"weight": uniform(d_in, d_out)}
    if with_bias:
        params["bias"] = uniform(d_out)
    return params


def linear_apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    y = x @ params["weight"]
    if "bias" in params:
        y = y + params["bias"]
    return y
