"""Shared building blocks: LibTorch-initialized Linear stacks.

Port of the Linear half of ``mmvae_tpu/models/modules.py`` and its
reparameterization; parameter dicts keep the reference's
``named_parameters`` names.  The Angular layer waits for the vMF port.
"""

from __future__ import annotations

import torch

from ..ops.initializers import linear_apply, torch_linear_init


def init_linear_stack(generator: torch.Generator, prefix: str, d_in: int,
                      hidden: list[int], d_final: int | None,
                      device: torch.device | str = "cpu"
                      ) -> tuple[dict, list[str], int]:
    """One Linear per hidden dim (``{prefix}_1..{prefix}_k``), then, when
    ``d_final`` is given, a final Linear named ``{prefix}``.

    Returns (params, ordered layer names, output dim of the stack)."""
    params: dict = {}
    names: list[str] = []
    d_prev = d_in
    for i, d_next in enumerate(hidden):
        name = f"{prefix}_{i + 1}"
        params[name] = torch_linear_init(generator, d_prev, d_next,
                                         device=device)
        names.append(name)
        d_prev = d_next
    if d_final is not None:
        params[prefix] = torch_linear_init(generator, d_prev, d_final,
                                           device=device)
        names.append(prefix)
        d_prev = d_final
    return params, names, d_prev


def apply_stack(params: dict, names: list[str], x: torch.Tensor,
                do_relu: bool, relu_last: bool) -> torch.Tensor:
    """Apply a named Linear stack with optional inter-layer ReLU
    (``relu_last``: encoder stacks ReLU after every layer, decoder stacks
    not after the final map)."""
    h = x
    for i, name in enumerate(names):
        h = linear_apply(params[name], h)
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
