"""Packed NB-VAE training step: reporting pass + bootstrap Adam steps.

Port of ``mmvae_tpu/ops/nb_fast.py`` (``_Rows``, ``PackedFastStep``
with ``batch_step``'s ``rand=`` entry point, ``NBFastStep``,
``_make_packed_optimizer``) for the reference's default architecture
(direct D->R encoder and R->D decoder, no hidden layers).
:class:`PackedFastStep` is the skeleton the joint model's step
(``ops/vmfnb_fast.py``) shares.

- **Packed parameters.**  Every D-sized parameter row lives in one
  (K, D) float32 matrix ``P``; every small parameter in one flat vector
  ``sv``.  The optimizer runs on the two leaves ``{P, sv}``.
- **Folded standardization.**  ``((log1p(x) - x_mean) / sd) @ W`` is
  ``log1p(x) @ (W / sd)^T - x_mean @ (W / sd)^T``, so each encoder pass
  is the fused count-encoder (K4 forward, K5 backward) straight from the
  integer counts; the nu / depth rows ride the same call against ``x``.
- **Bootstrap on the input rows.**  Each boot step gathers ``x[ridx]``
  and re-encodes it, as the JAX step does.
- **Kernels.**  The reporting pass runs :func:`nb_step_report` (K1, K6),
  each boot step :func:`nb_step_boot_gradonly` (K1, K2, K3).

``NBFastStep(..., plain=True)`` is the plain route of the same step —
``count_encode_ref`` and the differentiable ``step_nll_ref`` under
autograd, the JAX package's XLA path — used to hold the kernel route
against it on the card.

Randomness is passed in (``rand``), never drawn in the step:
:meth:`PackedFastStep.draw_rand` draws a whole epoch from a
``torch.Generator``, and the parity tests feed JAX's ``draw_rand`` draws
through :func:`rand_from_numpy`, so both packages see the same noise.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..parallel.collectives import pmean
from .enc_kernel import count_encode, count_encode_ref
from .losses import gaussian_kl, kl_weight_schedule
from .nb_elbo import _softplus
from .nb_step import nb_step_boot_gradonly, nb_step_report, step_nll_ref


@dataclass(frozen=True)
class _Rows:
    """Row indices of the packed (K, D) parameter matrix (same layout as
    the JAX package's, so packed states carry over unchanged)."""

    R: int
    C: int
    H: int
    Rn: int

    @property
    def mu_dec_w(self):  # (R, D)
        return slice(0, self.R)

    @property
    def cov_dec_w(self):  # (C, D)
        return slice(self.R, self.R + self.C)

    @property
    def mu_dec_b(self):
        return self.R + self.C

    @property
    def cov_dec_b(self):
        return self.R + self.C + 1

    @property
    def mu_bias(self):
        return self.R + self.C + 2

    @property
    def nu_dec_w(self):  # (Rn, D)
        a = self.R + self.C + 3
        return slice(a, a + self.Rn)

    @property
    def nu_dec_b(self):
        return self.R + self.C + 3 + self.Rn

    @property
    def nu_bias(self):
        return self.R + self.C + 4 + self.Rn

    @property
    def x_mean(self):
        return self.R + self.C + 5 + self.Rn

    @property
    def ln_x_sd(self):
        return self.R + self.C + 6 + self.Rn

    @property
    def mu_enc_w(self):  # (R, D), transposed storage
        a = self.R + self.C + 7 + self.Rn
        return slice(a, a + self.R)

    @property
    def nu_enc_w(self):  # (H, D), transposed storage
        a = self.R + self.C + 7 + self.Rn + self.R
        return slice(a, a + self.H)

    @property
    def depth_w(self):  # (1, D), transposed storage
        return self.R + self.C + 7 + self.Rn + self.R + self.H

    @property
    def nd_rows(self):  # (H + 1, D): nu_enc_w rows, then the depth row
        a = self.R + self.C + 7 + self.Rn + self.R
        return slice(a, a + self.H + 1)

    @property
    def K(self):
        return self.R + self.C + 8 + self.Rn + self.R + self.H


def tree_leaves(tree: dict) -> list:
    """The tensors of a nested dict in JAX's pytree order (keys sorted,
    depth first)."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        out.extend(tree_leaves(v) if isinstance(v, dict) else [v])
    return out


def tree_unflatten(template: dict, leaves) -> dict:
    """A nested dict shaped like ``template`` holding ``leaves`` in
    :func:`tree_leaves` order."""
    it = iter(leaves)

    def build(t):
        return {k: build(t[k]) if isinstance(t[k], dict) else next(it)
                for k in sorted(t)}

    return build(template)


class PackedAdam:
    """The JAX trainer's optimizer over any nested dict of tensors (the
    packed ``{P, sv}`` or the named parameter tree): optax's
    ``chain(clip_by_global_norm(grad_clip), add_decayed_weights(wd),
    scale_by_adam(0.9, 0.999, eps=1e-8), scale(-lr))``
    (``train/loop.py:46-60``, ``ops/nb_fast.py:586-593``).

    Not ``torch.optim.AdamW``: the clip divides first
    (``g / |g| * max`` when ``|g| >= max``), weight decay is added to the
    gradient before the moments, and the moment count is incremented
    before the bias correction.  The global norm sums the leaves in JAX's
    pytree order.  The state is ``{"count": int32 scalar, "mu": tree,
    "nu": tree}``; updates are out of place.

    ``tp=True`` is ``make_optimizer(tp=True)``'s chain, without the clip:
    tensor-parallel training clips against the norm across the model row
    before the update (``train.loop.tp_clip``)."""

    def __init__(self, lr: float, grad_clip: float, weight_decay: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 tp: bool = False):
        self.lr, self.grad_clip, self.weight_decay = lr, grad_clip, \
            weight_decay
        self.b1, self.b2, self.eps = b1, b2, eps
        self.tp = tp

    @staticmethod
    def init(q: dict) -> dict:
        leaves = tree_leaves(q)
        zeros = [torch.zeros_like(v) for v in leaves]
        return {"count": torch.zeros((), dtype=torch.int32,
                                     device=leaves[0].device),
                "mu": tree_unflatten(q, zeros),
                "nu": tree_unflatten(q, [z.clone() for z in zeros])}

    def update(self, grads: dict, state: dict, q: dict
               ) -> tuple[dict, dict]:
        gs, ps = tree_leaves(grads), tree_leaves(q)
        ms, vs = tree_leaves(state["mu"]), tree_leaves(state["nu"])
        if not self.tp:
            g_norm = torch.sqrt(sum((torch.sum(g * g) for g in gs),
                                    torch.zeros((), device=ps[0].device)))
            trigger = g_norm < self.grad_clip
        count = state["count"] + 1
        cf = count.to(torch.float32)
        # scalar bases: no host-to-device copy (which would synchronise)
        bc1 = 1.0 - torch.pow(self.b1, cf)
        bc2 = 1.0 - torch.pow(self.b2, cf)
        new_q, mu, nu = [], [], []
        for g, p, m, v in zip(gs, ps, ms, vs):
            if not self.tp:
                g = torch.where(trigger, g, (g / g_norm) * self.grad_clip)
            g = g + self.weight_decay * p
            mu.append((1 - self.b1) * g + self.b1 * m)
            nu.append((1 - self.b2) * (g * g) + self.b2 * v)
            u = (mu[-1] / bc1) / (torch.sqrt(nu[-1] / bc2) + self.eps)
            new_q.append(p + u * (-self.lr))
        return tree_unflatten(q, new_q), {
            "count": count, "mu": tree_unflatten(q, mu),
            "nu": tree_unflatten(q, nu)}


def rand_from_numpy(tree, device: torch.device | str = "cpu"):
    """A ``draw_rand`` tree of numpy arrays (e.g. the JAX package's draws)
    -> tensors: integer leaves int64, the rest float32."""
    if isinstance(tree, dict):
        return {k: rand_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(rand_from_numpy(v, device) for v in tree)
    a = np.asarray(tree)
    dt = torch.int64 if np.issubdtype(a.dtype, np.integer) else torch.float32
    return torch.tensor(a, dtype=dt, device=device)


def draw_rand(gen: torch.Generator, nbatch: int, B: int, nboot: int,
              widths: tuple) -> dict:
    """Every draw of ``nbatch`` batch steps, with the structure of the
    JAX package's ``draw_rand`` / ``_draw_batch``: ``rep_eps`` (one
    (nbatch, B, w) per reparameterization width), ``ridx`` (nbatch, nboot,
    B), ``boot_eps`` ((nbatch, nboot, B, w) per width), drawn on the
    generator's device in one go.  The packed steps and the generic
    ``Trainer`` share it."""
    dev = gen.device

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    rep_eps = tuple(normal(nbatch, B, w) for w in widths)
    ridx = torch.randint(0, B, (nbatch, nboot, B), generator=gen,
                         device=dev)
    boot_eps = tuple(normal(nbatch, nboot, B, w) for w in widths)
    return dict(rep_eps=rep_eps, ridx=ridx, boot_eps=boot_eps)


def reduce_step(grads: list, report, i: int, group=None
                ) -> tuple[list, object]:
    """Boot step ``i``'s gradients ``pmean``-ed over the ranks of
    ``group`` (default the world), with the report in the same collective
    when ``i`` is 0."""
    red = pmean(grads + [report] if i == 0 else grads, group)
    return red[:len(grads)], red[-1] if i == 0 else report


def batch_rand(rand: dict, b: int) -> dict:
    """Batch ``b``'s slice of an epoch of draws."""
    return {"rep_eps": tuple(e[b] for e in rand["rep_eps"]),
            "ridx": rand["ridx"][b],
            "boot_eps": tuple(e[b] for e in rand["boot_eps"])}


def superbatch_step(step, q, opt_state, x_sb, c_sb, epoch_f, beta, rand,
                    record_fn=None, mesh=None):
    """The S batch steps of ``x_sb`` (S, B, D) and ``c_sb`` (S, B, C) in
    order, each ``step.batch_step`` on the state the one before left (the
    scan body of JAX's ``Trainer._superbatch_step`` and
    ``_superbatch_step_fast``, train/loop.py:341-409), at ``epoch_f`` with
    its KL weight ``beta`` (a device scalar, which the step's
    ``beta_override`` hands every batch step in place of a host->device
    copy) and batch j's draws ``rand[...][j]``; on a recording superbatch
    ``record_fn(step.unpack(q), x)`` right after each batch's updates
    (the recorder's observation point, mmvae_alg.hh:315-317).  ``mesh``
    goes to every ``batch_step``, as JAX's scan body takes ``axis_name``:
    ``x_sb`` and ``c_sb`` are then this rank's rows (and features, under
    tensor parallelism) and ``rand`` its draws (``DataMesh.step_inputs``).
    Returns (q, opt_state, reports (S,), the record outputs stacked to
    (S, B, width) or None).  The body that
    ``train.superbatch.SuperbatchGraphs`` captures."""
    reps, recs = [], []
    step.beta_override = beta
    try:
        for j in range(x_sb.shape[0]):
            q, opt_state, rep = step.batch_step(
                q, opt_state, x_sb[j], c_sb[j], epoch_f,
                batch_rand(rand, j), mesh=mesh)
            reps.append(rep)
            if record_fn is not None:
                recs.append(record_fn(step.unpack(q), x_sb[j]))
    finally:
        step.beta_override = None
    enc = (None if record_fn is None
           else tuple(torch.stack(t) for t in zip(*recs)))
    return q, opt_state, torch.stack(reps), enc


class PackedFastStep:
    """Shared skeleton of the packed fast steps (JAX ``PackedFastStep``,
    ``ops/nb_fast.py:196-335``).

    A subclass gives ``_make_rows(model)``, ``_sv_entries()`` (the
    small-vector segments, in order), ``_eps_widths()`` (the latent width
    of each reparameterization draw), ``supports(model)``, ``pack`` /
    ``unpack`` and ``_loss(q, views, c, ridx, eps, beta, include_const,
    boot)``, and may give ``_views(x)``: the parameter-free data views
    computed once a batch and handed to every ``_loss`` of it (by
    default the counts themselves); :meth:`batch_step`,
    :meth:`draw_rand`, the small-vector layout, the packed optimizer and
    :func:`superbatch_step` (S batch steps, the body the superbatch
    graphs capture) are common.  The epoch runner in ``train/loop.py``
    drives any subclass through this protocol.
    ``plain=True`` selects the plain route of the same step (the JAX
    package's XLA path) instead of the kernels."""

    #: what the port raises where the JAX package would fall back to its
    #: generic step path for a model the packed step does not support
    UNSUPPORTED = ("the packed step does not take this architecture; it "
                   "trains on the generic step, train.loop.Trainer")

    def __init__(self, model, opt, kl=(1.0, 1e-2, 0.1), plain: bool = False):
        if not self.supports(model):
            raise NotImplementedError(self.UNSUPPORTED)
        self.model = model
        self.opt = opt
        self.kl_max, self.kl_min, self.kl_discount = kl
        self.plain = plain
        self.rows = self._make_rows(model)
        self._sv_segs, self._sv_len = self._seg_layout(self._sv_entries())
        self.optimizer = PackedAdam(opt.lr, opt.grad_clip, opt.weight_decay)
        self._beta = None
        # the KL weight as a device scalar (the superbatch graphs' buffer)
        self.beta_override = None

    # ------------------------------------------------------------------
    # layout: pack / unpack work on params AND on Adam-moment trees
    # ------------------------------------------------------------------
    @staticmethod
    def _seg_layout(entries):
        """``name -> (offset, shape)`` segment table and total length of
        the packed small vector."""
        segs, off = {}, 0
        for name, shape in entries:
            segs[name] = (off, shape)
            off += math.prod(shape)
        return segs, off

    def _sv(self, sv, name):
        off, shape = self._sv_segs[name]
        return sv[off:off + math.prod(shape)].reshape(shape)

    @staticmethod
    def _sv_leaf(t: dict, name: str):
        """The tree's leaf of a small-vector segment: ``top.leaf`` names a
        layer's leaf, a name without a dot a top-level tensor (the vMF
        model's ``ln_kappa``)."""
        for part in name.split("."):
            t = t[part]
        return t

    def _pack_sv(self, t: dict) -> torch.Tensor:
        return torch.cat([self._sv_leaf(t, n).reshape(-1)
                          for n in self._sv_segs])

    def _unpack_sv(self, sv, out: dict) -> dict:
        for name in self._sv_segs:
            *top, leaf = name.split(".")
            node = out.setdefault(top[0], {}) if top else out
            node[leaf] = self._sv(sv, name)
        return out

    def pack_opt_state(self, state: dict) -> dict:
        """Named Adam state ``{count, mu, nu}`` -> packed."""
        return {"count": state["count"], "mu": self.pack(state["mu"]),
                "nu": self.pack(state["nu"])}

    def unpack_opt_state(self, state: dict) -> dict:
        return {"count": state["count"], "mu": self.unpack(state["mu"]),
                "nu": self.unpack(state["nu"])}

    @staticmethod
    def _reparam(eps, mean, lnvar):
        return mean + eps * torch.exp(lnvar / 2.0)

    @staticmethod
    def _views(x):
        """The per-batch data views every ``_loss`` of a batch step takes
        (JAX ``batch_step``'s ``views = self._views(x)``); by default the
        counts themselves."""
        return x

    # ------------------------------------------------------------------
    # randomness
    # ------------------------------------------------------------------
    def draw_rand(self, gen: torch.Generator, nbatch: int, B: int) -> dict:
        """:func:`draw_rand` at the widths of :meth:`_eps_widths`."""
        return draw_rand(gen, nbatch, B, self.opt.nboot, self._eps_widths())

    def _beta_for(self, epoch_f: float, device) -> torch.Tensor:
        """``epoch_f``'s KL weight on ``device`` (kept for the epoch), or
        ``beta_override`` while a superbatch step sets it."""
        if self.beta_override is not None:
            return self.beta_override
        key = (float(epoch_f), str(device))
        if self._beta is None or self._beta[0] != key:
            beta = kl_weight_schedule(epoch_f, self.kl_max, self.kl_min,
                                      self.kl_discount).to(device)
            self._beta = (key, beta)
        return self._beta[1]

    def batch_step(self, q: dict, opt_state: dict, x, c, epoch_f,
                   rand: dict, mesh=None):
        """One reference batch step on packed state: the reporting pass
        (no update) and ``nboot`` bootstrap-resampled Adam steps
        (mmvae_alg.hh:277-311).  Returns (q, opt_state, report).

        With a :class:`~mmvae_tpu_torch.parallel.mesh.DataMesh` (JAX's
        ``axis_name``) ``x`` and ``c`` are this rank's rows, the boot
        passes draw from :meth:`DataMesh.step_inputs`, and the report and
        each boot step's gradients are ``pmean``-ed: the report rides the
        first boot step's collective."""
        beta = self._beta_for(epoch_f, x.device)
        xb, cb = x, c
        if mesh is not None:
            xb, cb, rand = mesh.step_inputs(x, c, rand)
        views = self._views(x)
        bviews = views if xb is x else self._views(xb)
        with torch.no_grad():
            report = self._loss(q, views, c, None, rand["rep_eps"], beta,
                                include_const=True, boot=False)
        for i in range(self.opt.nboot):
            qq = {k: v.detach().requires_grad_() for k, v in q.items()}
            eps = tuple(e[i] for e in rand["boot_eps"])
            loss = self._loss(qq, bviews, cb, rand["ridx"][i], eps, beta,
                              include_const=False, boot=True)
            grads = list(torch.autograd.grad(loss, (qq["P"], qq["sv"])))
            if mesh is not None:
                grads, report = reduce_step(grads, report, i)
            with torch.no_grad():
                q, opt_state = self.optimizer.update(
                    {"P": grads[0], "sv": grads[1]}, opt_state, q)
        if mesh is not None and self.opt.nboot == 0:
            report = pmean([report])[0]
        return q, opt_state, report

    superbatch_step = superbatch_step


class NBFastStep(PackedFastStep):
    """Packed-parameter step for :class:`~mmvae_tpu_torch.models.nb.NBVAE`:
    converts between the named parameter dict (artifact and checkpoint
    surface) and ``{P: (K, D), sv: (n,)}``, and runs one reference batch
    step — reporting pass plus ``nboot`` bootstrap Adam steps
    (mmvae_alg.hh:277-311) — on the packed state."""

    UNSUPPORTED = ("the packed step takes only the direct (no hidden "
                   "layer) NB architecture; hidden layers train on the "
                   "generic step, train.loop.Trainer (ROADMAP.md Queue 1 "
                   "item 11)")

    @staticmethod
    def supports(model) -> bool:
        from ..models.nb import NBVAE

        return (isinstance(model, NBVAE) and not model.mean_encoding
                and not model.mean_decoding)

    @staticmethod
    def _make_rows(model):
        return _Rows(R=model.mean_latent, C=model.covar_dim,
                     H=model.overdisp_encoding, Rn=model.overdisp_latent)

    def _sv_entries(self):
        R, C, H, Rn = self.rows.R, self.rows.C, self.rows.H, self.rows.Rn
        return [("mu_encoding.bias", (R,)),
                ("covar_encoding.weight", (C, R)),
                ("covar_encoding.bias", (R,)),
                ("mu_representation_mean.weight", (R, R)),
                ("mu_representation_mean.bias", (R,)),
                ("mu_representation_logvariance.weight", (R, R)),
                ("mu_representation_logvariance.bias", (R,)),
                ("nu_encoding.bias", (H,)),
                ("nu_representation_mean.weight", (H, Rn)),
                ("nu_representation_mean.bias", (Rn,)),
                ("nu_representation_logvariance.weight", (H, Rn)),
                ("nu_representation_logvariance.bias", (Rn,)),
                ("depth.bias", (1,))]

    def _eps_widths(self):
        return (self.rows.R, self.rows.Rn)  # (mu, nu)

    def pack(self, t: dict) -> dict:
        P = torch.cat([
            t["mu_decoding"]["weight"],
            t["covar_decoding"]["weight"],
            t["mu_decoding"]["bias"][None, :],
            t["covar_decoding"]["bias"][None, :],
            t["mu_bias"],
            t["nu_decoding"]["weight"],
            t["nu_decoding"]["bias"][None, :],
            t["nu_bias"],
            t["x_mean"],
            t["ln_x_sd"],
            t["mu_encoding"]["weight"].T,
            t["nu_encoding"]["weight"].T,
            t["depth"]["weight"].T,
        ], dim=0).contiguous()
        assert P.shape[0] == self.rows.K
        return {"P": P, "sv": self._pack_sv(t)}

    def unpack(self, q: dict) -> dict:
        P = q["P"]
        r = self.rows
        out = {
            "x_mean": P[r.x_mean][None, :],
            "ln_x_sd": P[r.ln_x_sd][None, :],
            "mu_bias": P[r.mu_bias][None, :],
            "nu_bias": P[r.nu_bias][None, :],
            "mu_decoding": {"weight": P[r.mu_dec_w], "bias": P[r.mu_dec_b]},
            "covar_decoding": {"weight": P[r.cov_dec_w],
                               "bias": P[r.cov_dec_b]},
            "nu_decoding": {"weight": P[r.nu_dec_w], "bias": P[r.nu_dec_b]},
            "mu_encoding": {"weight": P[r.mu_enc_w].T},
            "nu_encoding": {"weight": P[r.nu_enc_w].T},
            "depth": {"weight": P[r.depth_w][:, None]},
        }
        return self._unpack_sv(q["sv"], out)

    # ------------------------------------------------------------------
    # compute
    # ------------------------------------------------------------------
    def _heads(self, q, x, c):
        """Encoder heads (reference nb.hh:403-431, 444-451, 498) with the
        standardization folded into the count-encoder contraction."""
        P, sv = q["P"], q["sv"]
        r = self.rows
        H = r.H
        sd = _softplus(P[r.ln_x_sd]) + 1e-4                  # (D,)
        Wt = P[r.mu_enc_w] / sd                              # (R, D)
        enc = count_encode_ref if self.plain else count_encode
        hL, nd = enc(x, Wt, P[r.nd_rows])
        h = hL - P[r.x_mean] @ Wt.T                          # (B, R)
        h = h + self._sv(sv, "mu_encoding.bias")
        if self.model.do_relu:
            h = torch.relu(h)
        mu_mean = (h @ self._sv(sv, "mu_representation_mean.weight")
                   + self._sv(sv, "mu_representation_mean.bias")
                   + c @ self._sv(sv, "covar_encoding.weight")
                   + self._sv(sv, "covar_encoding.bias"))
        mu_lnvar = torch.clamp(
            h @ self._sv(sv, "mu_representation_logvariance.weight")
            + self._sv(sv, "mu_representation_logvariance.bias"), -4.0, 4.0)
        nu_h = nd[:, :H] + self._sv(sv, "nu_encoding.bias")
        nu_mean = (nu_h @ self._sv(sv, "nu_representation_mean.weight")
                   + self._sv(sv, "nu_representation_mean.bias"))
        nu_lnvar = torch.clamp(
            nu_h @ self._sv(sv, "nu_representation_logvariance.weight")
            + self._sv(sv, "nu_representation_logvariance.bias"), -4.0, 4.0)
        depth = _softplus(nd[:, H:] + self._sv(sv, "depth.bias"))  # (B, 1)
        return mu_mean, mu_lnvar, nu_mean, nu_lnvar, depth

    def _kernel_rows(self, P):
        r = self.rows
        return (P[r.mu_dec_w], P[r.cov_dec_w],
                P[r.mu_dec_b] + P[r.cov_dec_b] + P[r.mu_bias],
                P[r.nu_dec_w], P[r.nu_dec_b] - P[r.nu_bias])

    def _loss(self, q, x, c, ridx, eps, beta, include_const: bool,
              boot: bool):
        if ridx is not None:
            # resample the INPUT rows and re-encode them (as in JAX)
            x = x.index_select(0, ridx)
            c = c.index_select(0, ridx)
        mu_mean, mu_lnvar, nu_mean, nu_lnvar, depth = self._heads(q, x, c)
        z_mu = self._reparam(eps[0], mu_mean, mu_lnvar)
        z_nu = self._reparam(eps[1], nu_mean, nu_lnvar)
        kl = gaussian_kl(mu_mean, mu_lnvar) + gaussian_kl(nu_mean, nu_lnvar)
        args = (x, z_mu, c, z_nu, depth, *self._kernel_rows(q["P"]))
        if self.plain:
            nll = step_nll_ref(*args, include_const=include_const)
        elif boot:
            nll = nb_step_boot_gradonly(*args)
        else:
            nll = nb_step_report(*args, include_const=include_const)
        return (nll + beta * kl) / x.shape[0]
