"""Plain PyTorch pieces the models' references share.

Written from the published model (YPARK/mm-vae: ``include/models/
nb.hh``, ``vmfnb.hh``, ``include/operators.hh``, ``mmvae_alg.hh``) and
optax's documented optimizer chain, in float32 with TF32 off.  Nothing
here imports the program under test: the reference judges the program,
so it works everything out again from the inputs the benchmark makes.
"""

from __future__ import annotations

import contextlib
import math
import os
import struct

import torch
import torch.nn.functional as F


# ----------------------------------------------------------------------
# trees: nested dicts of tensors, leaves named by their dotted path
# ----------------------------------------------------------------------

def leaves(tree: dict, prefix: str = "") -> dict:
    """``{"a.b": tensor}`` of a nested dict, keys in sorted order."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(leaves(v, name + "."))
        else:
            out[name] = v
    return out


def rebuild(template: dict, flat: dict, prefix: str = "") -> dict:
    """The nested dict of ``template``'s shape holding ``flat``'s
    tensors."""
    return {k: (rebuild(v, flat, f"{prefix}{k}.") if isinstance(v, dict)
                else flat[f"{prefix}{k}"]) for k, v in template.items()}


def uniform_leaves(gen: torch.Generator, spec: list, device) -> dict:
    """LibTorch's ``nn.Linear`` default, U(-1/sqrt(fan_in), 1/sqrt(fan_in))
    for weight and bias, of every ``(name, shape, fan_in)`` in ``spec``,
    from ONE draw of the generator on ``device``: ``{name: tensor}``."""
    sizes = [math.prod(shape) for _, shape, _ in spec]
    u = torch.rand(sum(sizes), generator=gen, device=device)
    out, off = {}, 0
    for (name, shape, fan_in), n in zip(spec, sizes):
        bound = 1.0 / math.sqrt(fan_in)
        out[name] = (u[off:off + n] * (2.0 * bound) - bound).reshape(shape)
        off += n
    return out


def linear(layer: dict, x: torch.Tensor) -> torch.Tensor:
    """A linear layer stored (in, out), with its bias when it has one."""
    y = x @ layer["weight"]
    return y + layer["bias"] if "bias" in layer else y


# ----------------------------------------------------------------------
# the model's pieces
# ----------------------------------------------------------------------

def softplus(v: torch.Tensor) -> torch.Tensor:
    return F.softplus(v)


def reparam(mean, lnvar, eps):
    """``mean + eps * exp(lnvar / 2)`` (nb.hh:462-472)."""
    return mean + eps * torch.exp(lnvar / 2.0)


def gaussian_kl(mean, lnvar):
    """KL(N(mean, exp(lnvar)) || N(0, I)) summed (nb.hh:533-537)."""
    return -0.5 * torch.sum(1.0 + lnvar - mean * mean - torch.exp(lnvar))


def nb_nll(x, mu, nu, include_const: bool):
    """The negative binomial NLL summed over the batch and the genes
    (nb.hh:511-531): ``mu`` the mean (depth-scaled), ``nu`` the
    overdispersion, both before the 1e-4 guard this adds."""
    x = x.float()
    mu = mu + 1e-4
    nu = nu + 1e-4
    denom = torch.log(mu + nu)
    t = (torch.lgamma(nu) - torch.lgamma(nu + x)
         + x * (denom - torch.log(mu)) + nu * (denom - torch.log(nu)))
    if include_const:
        t = t + torch.lgamma(x + 1.0)
    return torch.sum(t)


def l2_normalize(v, dim=1):
    """``F::normalize`` (p = 2, eps = 1e-12)."""
    n = torch.sqrt(torch.sum(v * v, dim=dim, keepdim=True))
    return v / torch.clamp_min(n, 1e-12)


def _f32(x: float) -> float:
    return struct.unpack("<f", struct.pack("<f", x))[0]


def fasterlog(x: float) -> float:
    """Mineiro's ``fasterlog`` (include/utils/fastlog.h), which the
    published model uses for its loss constants and kappa bounds: the
    float's bit pattern, itself rounded to a float, times 2^-23 ln 2,
    less 87.989971088, each step in float32."""
    bits = struct.unpack("<I", struct.pack("<f", x))[0]
    y = _f32(_f32(float(bits)) * _f32(8.2629582881927490e-8))
    return _f32(y - _f32(87.989971088))


def fasterlgamma(x: float) -> float:
    """Mineiro's ``fasterlgamma`` (include/utils/fastgamma.h), float32:
    ``-0.0810614667 - x - fasterlog(x) + (0.5 + x) fasterlog(1 + x)``."""
    x = _f32(x)
    acc = _f32(_f32(-0.0810614667) - x)
    acc = _f32(acc - fasterlog(x))
    return _f32(acc + _f32(_f32(_f32(0.5) + x) * fasterlog(_f32(1.0 + x))))


class _LogBessel(torch.autograd.Function):
    """log I_df(kappa) as operators.hh:13-101 has it: the forward is the
    two-regime approximation of Oh, Adamczewski and Park (2019), the
    backward the midpoint of Baricz's (2011) bounds on I'/I, which the
    published model trains with in place of the true derivative."""

    @staticmethod
    def forward(ctx, kappa, df):
        ctx.save_for_backward(kappa)
        ctx.df = df
        eta = (df + 0.5) / (2.0 * (df + 1.0))
        low = (df * torch.log(kappa) + eta * kappa
               - (eta + df) * math.log(2.0) - fasterlgamma(df + 1.0))
        high = kappa - 0.5 * torch.log(kappa) - 0.5 * math.log(2.0 * math.pi)
        return torch.where(kappa <= df, low, high)

    @staticmethod
    def backward(ctx, g):
        (kappa,) = ctx.saved_tensors
        df = ctx.df
        lo = torch.sqrt(kappa * kappa * df / (df + 1.0) + df * df)
        hi = torch.sqrt(kappa * kappa + df * df)
        return g * 0.5 * (lo + hi) / kappa, None


def log_bessel(kappa, df: float):
    return _LogBessel.apply(kappa, float(df))


def cluster_order(gmax: torch.Tensor, device_type: str, covar_dim: int):
    """The gene order a trainer that clusters features (the JAX trainer's
    ``feature_perm``, which the CLIs use) trains in, worked out from the
    counts' per-gene maxima: the genes with a count above 7 (the hot
    genes) moved after the others, each group in input order.  None where
    the trainer keeps input order: ``MMVAE_FEATURE_PERM=0``, a covariate
    as wide as the genes, no step kernels (they run on a card at D >=
    512, unless ``MMVAE_FEATURE_PERM=force``), or no gene, or more than
    half of them, hot.  Its inverse puts a tree trained in that order
    back in input order."""
    D = gmax.shape[0]
    env = os.environ.get("MMVAE_FEATURE_PERM", "1")
    if env == "0" or covar_dim == D or not (
            env == "force" or (device_type == "cuda" and D >= 512)):
        return None
    hot = (gmax > 7).cpu()
    if not bool(hot.any()) or float(hot.float().mean()) > 0.5:
        return None
    return torch.argsort(hot.to(torch.int8), stable=True)


def in_order(tree: dict, order, D: int) -> dict:
    """``{name: tensor}`` with every axis of size D taken in ``order``."""
    out = {}
    for k, t in tree.items():
        for ax, n in enumerate(t.shape):
            if n == D:
                t = t.index_select(ax, order)
        out[k] = t
    return out


# ----------------------------------------------------------------------
# the optimizer and the batch step
# ----------------------------------------------------------------------

class Adam:
    """optax's ``chain(clip_by_global_norm(clip), add_decayed_weights(wd),
    scale_by_adam(b1, b2, eps), scale(-lr))`` (mmvae_alg.hh:14-33 gives
    lr, clip and the decay) on ``{name: tensor}``."""

    def __init__(self, lr, clip, wd, b1=0.9, b2=0.999, eps=1e-8):
        self.lr, self.clip, self.wd = lr, clip, wd
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, p: dict) -> dict:
        return {"count": 0, "mu": {k: torch.zeros_like(v) for k, v in p.items()},
                "nu": {k: torch.zeros_like(v) for k, v in p.items()}}

    def update(self, g: dict, st: dict, p: dict):
        norm = torch.sqrt(sum(torch.sum(t * t) for t in g.values()))
        scale = torch.where(norm < self.clip, torch.ones_like(norm),
                            self.clip / norm)
        n = st["count"] + 1
        c1, c2 = 1.0 - self.b1 ** n, 1.0 - self.b2 ** n
        out = {"count": n, "mu": {}, "nu": {}}
        newp = {}
        for k, v in p.items():
            gk = g[k] * scale + self.wd * v
            m = self.b1 * st["mu"][k] + (1.0 - self.b1) * gk
            s = self.b2 * st["nu"][k] + (1.0 - self.b2) * gk * gk
            out["mu"][k], out["nu"][k] = m, s
            newp[k] = v - self.lr * (m / c1) / (torch.sqrt(s / c2) + self.eps)
        return newp, out


def kl_weight(cfg: dict, epoch: int) -> float:
    """beta(t) = max(kl_min, kl_max exp(-kl_discount t)) (nb_vae_main.cc)."""
    return max(cfg["kl_min"], cfg["kl_max"] * math.exp(-cfg["kl_discount"]
                                                        * epoch))


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """TF32 on or off for float32 products while the block runs."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def follow(loss_fn, cfg: dict, params: dict, steps: list, beta: float,
           fault: str | None = None, state: dict | None = None) -> dict:
    """The published batch step (mmvae_alg.hh:277-311) over ``steps``, a
    list of batch steps ``(x, c, draws)``: the report (no update) is the
    loss on the batch's rows with the reporting draws and the data
    constant; then ``nboot`` times the rows are resampled (``ridx``) and
    the optimizer steps on the gradient.  ``loss_fn(params, x, c, eps,
    beta, include_const)`` is the model's loss, a mean over the batch's
    rows.  ``params`` is the parameter tree to start from and ``state``
    the optimizer's (``{"count", "mu", "nu"}``, named leaves), fresh when
    None.

    ``fault`` plants a fault for the benchmark's control runs:
    ``"half_batch"`` drops the second half of every batch's rows and
    takes the mean over the rest.

    Returns ``{"reports": [float], "params": {name: tensor}, "mu":
    {name: tensor}, "params0": {name: tensor}}``: the reports of every
    step, and the parameters and the optimizer's first moment after the
    last."""
    opt = Adam(cfg["lr"], cfg["grad_clip"], cfg["weight_decay"])
    p0 = leaves(params)
    p = {k: v.detach().clone() for k, v in p0.items()}
    st = opt.init(p) if state is None else state
    reports = []
    for x, c, dr in steps:
        with torch.no_grad():
            xr, cr, eps = _cut(fault, x, c, dr["rep_eps"])
            reports.append(float(loss_fn(rebuild(params, p), xr, cr, eps,
                                         beta, True)))
        for i in range(cfg["nboot"]):
            idx = dr["ridx"][i]
            eps = tuple(e[i] for e in dr["boot_eps"])
            xb, cb = x.index_select(0, idx), c.index_select(0, idx)
            xb, cb, eps = _cut(fault, xb, cb, eps)
            q = {k: v.detach().requires_grad_() for k, v in p.items()}
            loss = loss_fn(rebuild(params, q), xb, cb, eps, beta, False)
            grads = dict(zip(q, torch.autograd.grad(loss, list(q.values()))))
            with torch.no_grad():
                p, st = opt.update(grads, st, p)
    return {"reports": reports, "params": p, "mu": st["mu"], "params0": p0}


def _cut(fault, x, c, eps):
    if fault != "half_batch":
        return x, c, eps
    h = x.shape[0] // 2
    return x[:h], c[:h], tuple(e[:h] for e in eps)
