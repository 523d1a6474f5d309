"""Shared building blocks: LibTorch-initialized Linear stacks and the
Angular layer.

Port of ``mmvae_tpu/models/modules.py``: Linear or Angular stacks and the
reparameterization; parameter dicts keep the reference's
``named_parameters`` names.
"""

from __future__ import annotations

import torch

from ..ops.initializers import linear_apply, torch_linear_init
from ..ops.losses import l2_normalize


def angular_init(generator: torch.Generator, d_in: int, d_out: int,
                 device: torch.device | str = "cpu") -> dict:
    """Angular layer parameters: a LibTorch-initialized (d_in, d_out)
    weight and no bias (reference AngularImpl, angular.hh:44-70)."""
    return torch_linear_init(generator, d_in, d_out, with_bias=False,
                             device=device)


def angular_apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Direction-only linear layer (angular.hh:34-42): ``x @
    l2_normalize(relu(W) + 1e-4)``, each output unit's weight vector, axis
    0 of the (d_in, d_out) weight, normalized."""
    return x @ l2_normalize(torch.relu(params["weight"]) + 1e-4, dim=0)


def init_linear_stack(generator: torch.Generator, prefix: str, d_in: int,
                      hidden: list[int], d_final: int | None,
                      device: torch.device | str = "cpu",
                      angular: bool = False) -> tuple[dict, list[str], int]:
    """One Linear (``angular``: Angular) layer per hidden dim
    (``{prefix}_1..{prefix}_k``), then, when ``d_final`` is given, a
    final one named ``{prefix}``.

    Returns (params, ordered layer names, output dim of the stack)."""
    init = angular_init if angular else torch_linear_init
    params: dict = {}
    names: list[str] = []
    d_prev = d_in
    for i, d_next in enumerate(hidden):
        name = f"{prefix}_{i + 1}"
        params[name] = init(generator, d_prev, d_next, device=device)
        names.append(name)
        d_prev = d_next
    if d_final is not None:
        params[prefix] = init(generator, d_prev, d_final, device=device)
        names.append(prefix)
        d_prev = d_final
    return params, names, d_prev


def apply_stack(params: dict, names: list[str], x: torch.Tensor,
                do_relu: bool, relu_last: bool,
                angular: bool = False) -> torch.Tensor:
    """Apply a named Linear (``angular``: Angular) stack with optional
    inter-layer ReLU (``relu_last``: encoder stacks ReLU after every
    layer, decoder stacks not after the final map)."""
    apply = angular_apply if angular else linear_apply
    h = x
    for i, name in enumerate(names):
        h = apply(params[name], h)
        if do_relu and (relu_last or i + 1 < len(names)):
            h = torch.relu(h)
    return h


def reparameterize(mean: torch.Tensor, lnvar: torch.Tensor,
                   eps: torch.Tensor | None = None) -> torch.Tensor:
    """Gaussian reparameterization (reference include/models/nb.hh:462-472,
    ``mmvae_tpu/models/modules.py:99-108``): training mode gets its
    standard-normal noise ``eps`` injected and returns
    ``mean + eps * exp(lnvar / 2)``; eval mode (``eps`` None) returns the
    mean."""
    if eps is None:
        return mean
    return mean + eps * torch.exp(lnvar / 2.0)
