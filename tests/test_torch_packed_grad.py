"""How a boot pass of the packed steps gets its gradient
(``ops/nb_fast.py``: ``PackedFastStep._boot_grads`` and ``pack_grad``).

Each boot pass differentiates every row block of ``P`` and every segment
of ``sv`` as a leaf of its own and concatenates the block gradients into
the two packed gradients, in place of differentiating the whole ``P`` and
``sv`` through slices of them.  On the CPU:

- the four packed steps (NB, vMF, joint vMF+NB, mixture; kernel and
  plain routes), nboot 3, two batch steps, against the same steps with
  the whole-leaf boot pass: parameters, Adam state and reports bitwise;
  the same under a one-rank ``DataMesh`` (a gloo group of one process);
- each layout's blocks and segments cover ``P``'s rows and ``sv`` once,
  in order, at two widths;
- a block the loss does not read: a zero block, counted;
- ``pack_grad.launches``: 2 x nboot a batch step, eagerly and through
  ``SuperbatchGraphs``' eager form (the card's replays book it through
  ``train.superbatch.read_counts`` / ``add_counts``).
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from mmvae_tpu_torch.models.nb import NBVAE
from mmvae_tpu_torch.models.vmf import VMFVAE
from mmvae_tpu_torch.models.vmfnb import VMFNBVAE
from mmvae_tpu_torch.models.vmfnb_mixture import VMFNBMixtureVAE
from mmvae_tpu_torch.ops import nb_fast
from mmvae_tpu_torch.ops.nb_fast import NBFastStep, batch_rand, pack_grad
from mmvae_tpu_torch.ops.vmf_fast import VMFFastStep
from mmvae_tpu_torch.ops.vmfnb_fast import (VMFNBFastStep,
                                            VMFNBMixtureFastStep)
from mmvae_tpu_torch.parallel.mesh import DataMesh
from mmvae_tpu_torch.train.config import TrainingOptions
from mmvae_tpu_torch.train.superbatch import SuperbatchGraphs, read_counts

D, B, NBOOT = 40, 8, 3
KINDS = ("nb", "vmf", "joint", "mixture")


def _label(K=3):
    lab = np.zeros((D, K), np.float32)
    lab[np.arange(30), np.arange(30) % K] = 1.0
    return lab


def _model(kind, wide=False):
    """A model of each packed step, at the default widths or wider ones."""
    w = dict(mean_latent=4, overdisp_encoding=3, overdisp_latent=2) \
        if wide else {}
    if kind == "nb":
        return NBVAE(data_dim=D, covar_dim=3 if wide else 1, **w), NBFastStep
    if kind == "vmf":
        return (VMFVAE(data_dim=D, covar_dim=3 if wide else 1,
                       latent=4 if wide else 2), VMFFastStep)
    if kind == "joint":
        return VMFNBVAE(data_dim=D, **w), VMFNBFastStep
    return (VMFNBMixtureVAE(label=_label(5 if wide else 3), **w),
            VMFNBMixtureFastStep)


def _whole_leaf_grads(self, q, *loss_args):
    """The boot pass differentiating the whole ``P`` and ``sv`` through
    slices of them (``_loss`` on the packed ``q``)."""
    qq = {k: v.detach().requires_grad_() for k, v in q.items()}
    loss = self._loss(qq, *loss_args, include_const=False, boot=True)
    return list(torch.autograd.grad(loss, (qq["P"], qq["sv"])))


def _inputs(fast, model, nbatch=2):
    g = torch.Generator().manual_seed(11)
    q = fast.pack(model.init(torch.Generator().manual_seed(0)))
    rand = fast.draw_rand(g, nbatch, B)
    xs = torch.poisson(torch.full((nbatch, B, D), 1.3), generator=g)
    xs[:, :2, :4] += 20  # the mixed lgamma regime
    cs = torch.rand((nbatch, B, getattr(model, "covar_dim", 1)),
                    generator=g)
    return q, xs.to(torch.int16), cs, rand


def _steps(fast, q, xs, cs, rand, mesh=None):
    st = fast.optimizer.init(q)
    reps = []
    for b in range(xs.shape[0]):
        q, st, rep = fast.batch_step(q, st, xs[b], cs[b], 0.5,
                                     batch_rand(rand, b), mesh=mesh)
        reps.append(rep)
    return q, st, torch.stack(reps)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _assert_equal(got, want):
    gl, wl = _leaves(got), _leaves(want)
    assert len(gl) == len(wl) > 0
    for a, b in zip(gl, wl):
        assert torch.equal(a, b), float((a - b).abs().max())


@pytest.mark.parametrize("plain", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_block_leaves_equal_whole_leaves(kind, plain, monkeypatch):
    """Two batch steps (3 boot passes each): P, sv, the Adam moments and
    count and the reports bitwise those of the whole-leaf boot pass."""
    model, cls = _model(kind)
    fast = cls(model, TrainingOptions(nboot=NBOOT), plain=plain)
    q, xs, cs, rand = _inputs(fast, model)
    got = _steps(fast, q, xs, cs, rand)
    monkeypatch.setattr(nb_fast.PackedFastStep, "_boot_grads",
                        _whole_leaf_grads)
    want = _steps(fast, q, xs, cs, rand)
    _assert_equal(got, want)


def test_block_leaves_equal_whole_leaves_under_a_mesh(tmp_path,
                                                      monkeypatch):
    """The same under a one-rank mesh, where each boot pass's two packed
    gradients (and the report) go through ``pmean``."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        model, cls = _model("nb")
        fast = cls(model, TrainingOptions(nboot=NBOOT))
        q, xs, cs, rand = _inputs(fast, model)
        for mode in ("dp_shard", "data_parallel"):
            mesh = DataMesh(1, 0, torch.device("cpu"), mode)
            got = _steps(fast, q, xs, cs, rand, mesh)
            with monkeypatch.context() as m:
                m.setattr(nb_fast.PackedFastStep, "_boot_grads",
                          _whole_leaf_grads)
                want = _steps(fast, q, xs, cs, rand, mesh)
            _assert_equal(got, want)
            _assert_equal(got, _steps(fast, q, xs, cs, rand))
    finally:
        dist.destroy_process_group()


def _span(idx, width) -> tuple:
    if isinstance(idx, slice):
        return idx.start, idx.stop
    assert 0 <= idx < width
    return idx, idx + 1


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_blocks_cover_the_packed_leaves_in_order(kind, wide):
    """Each layout's row blocks cover P's rows, and the segments sv,
    once each and in layout order."""
    model, cls = _model(kind, wide)
    fast = cls(model, TrainingOptions(nboot=NBOOT))
    q = fast.pack(model.init(torch.Generator().manual_seed(0)))
    K, n = q["P"].shape[0], q["sv"].shape[0]
    at = 0
    for name in fast.rows.blocks:
        a, b = _span(getattr(fast.rows, name), K)
        assert a == at and b > a, name
        at = b
    assert at == K
    at = 0
    for name, (off, shape) in fast._sv_segs.items():
        assert off == at, name
        at += int(np.prod(shape))
    assert at == n == fast._sv_len


def test_unread_block_is_a_counted_zero_block(monkeypatch):
    """A block the boot loss does not read: its rows of the packed
    gradient are zeros (as the whole-leaf gradient's are), written as
    one zero block, counted in ``pack_grad.zero_launches``."""
    model, cls = _model("nb")
    fast = cls(model, TrainingOptions(nboot=NBOOT))
    q, xs, cs, rand = _inputs(fast, model)
    read = nb_fast.PackedFastStep._p

    def unread_x_mean(self, q, name):
        t = read(self, q, name)
        return t.detach() if name == "x_mean" else t

    monkeypatch.setattr(nb_fast.PackedFastStep, "_p", unread_x_mean)
    r = batch_rand(rand, 0)
    args = (xs[0], cs[0], r["ridx"][0], tuple(e[0] for e in r["boot_eps"]),
            torch.tensor(0.5))
    before = (pack_grad.launches, pack_grad.zero_launches)
    gP, gsv = fast._boot_grads(q, *args)
    assert (pack_grad.launches - before[0],
            pack_grad.zero_launches - before[1]) == (2, 1)
    rows = fast.rows.x_mean
    assert torch.count_nonzero(gP[rows]) == 0
    assert torch.count_nonzero(gP) > 0
    wP, wsv = _whole_leaf_grads(fast, q, *args)
    assert torch.equal(gP, wP) and torch.equal(gsv, wsv)


def test_pack_grad_concatenates_in_order():
    """``pack_grad`` alone: blocks of 2-D, 1-D and empty shapes, a None
    among them, in one flat order, viewed as the packed shape."""
    leaves = [torch.empty(2, 3), torch.empty(3), torch.empty(0, 3),
              torch.empty(1, 3)]
    cots = [torch.arange(6.).reshape(2, 3), None, torch.empty(0, 3),
            torch.full((1, 3), 7.)]
    z = pack_grad.zero_launches
    g = pack_grad(cots, leaves, (4, 3))
    assert pack_grad.zero_launches == z + 1
    assert torch.equal(g, torch.tensor([[0., 1, 2], [3, 4, 5], [0, 0, 0],
                                        [7, 7, 7]]))


@pytest.mark.parametrize("kind", KINDS)
def test_launches_counted_a_batch_step(kind):
    """Each eager batch step concatenates 2 x nboot packed gradients."""
    model, cls = _model(kind)
    fast = cls(model, TrainingOptions(nboot=NBOOT))
    q, xs, cs, rand = _inputs(fast, model)
    before = read_counts()
    _steps(fast, q, xs, cs, rand)
    after = read_counts()
    assert after["pack_grad.launches"] - before["pack_grad.launches"] \
        == 2 * NBOOT * xs.shape[0]
    assert after["pack_grad.zero_launches"] \
        == before["pack_grad.zero_launches"]


@pytest.mark.parametrize("S", [1, 3])
def test_launches_counted_a_superbatch(S):
    """A superbatch of s batches through ``SuperbatchGraphs``' eager form
    (the CPU's): 2 x nboot x s concatenations."""
    model, cls = _model("nb")
    fast = cls(model, TrainingOptions(nboot=NBOOT))
    q, xs, cs, rand = _inputs(fast, model, nbatch=S)
    sb = SuperbatchGraphs(fast, S, covar_dim=1)
    sb.set_state(q, fast.optimizer.init(q))
    sb.set_epoch(0)
    for s in (S, 1):
        sb.fill(xs[:s], cs[:s], {k: (v[:s] if isinstance(v, torch.Tensor)
                                     else tuple(e[:s] for e in v))
                                 for k, v in rand.items()})
        before = pack_grad.launches
        sb.run(s)
        assert pack_grad.launches - before == 2 * NBOOT * s
    assert sb.form == "eager"
    sb.close()
