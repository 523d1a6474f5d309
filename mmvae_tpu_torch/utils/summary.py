"""Model summary printed at train start: the port of
``mmvae_tpu/utils/summary.py``.

Reference parity: LibTorch's ``model->pretty_print(std::cerr)`` dumps
the module tree to stderr right before training (mmvae_alg.hh:238).
The port's models are ``nn.Module``s, so ``vars(model)`` would dump
module internals: the configuration printed is the model constructor's
arguments, in their order, which are the JAX model dataclass's fields.
For the same configuration and parameters both packages write the same
text.
"""

from __future__ import annotations

import inspect
import sys

import numpy as np


def pretty_print(model, params: dict, file=None) -> None:
    """Write a torch-style module summary to ``file`` (default stderr).

    One line per parameter group: ``name: weight (in, out) | bias (n,)``
    for layer dicts, ``name: (shape)`` for bare tensors.  Total trainable
    parameter count on the closing line.
    """
    out = file if file is not None else sys.stderr
    cfg = []
    # the constructor's arguments, in order: the JAX dataclass's fields
    for k in list(inspect.signature(type(model).__init__).parameters)[1:]:
        v = getattr(model, k)
        shape = getattr(v, "shape", None)
        if shape is not None and len(shape) > 0:
            # an array-valued field (the mixture's label): its shape only
            cfg.append(f"{k}=<{'x'.join(str(s) for s in shape)} array>")
        else:
            cfg.append(f"{k}={v}")
    out.write(f"{type(model).__name__}({', '.join(cfg)})\n")

    total = 0
    for name in sorted(params):
        val = params[name]
        if isinstance(val, dict):
            parts = []
            order = [s for s in ("weight", "bias") if s in val]
            order += [s for s in sorted(val) if s not in ("weight", "bias")]
            for sub in order:
                shape = tuple(val[sub].shape)
                total += int(np.prod(shape))
                parts.append(f"{sub} {shape}")
            out.write(f"  ({name}): {' | '.join(parts)}\n")
        else:
            shape = tuple(val.shape)
            total += int(np.prod(shape))
            out.write(f"  ({name}): {shape}\n")
    out.write(f"  [{total:,} parameters]\n")
    out.flush()
