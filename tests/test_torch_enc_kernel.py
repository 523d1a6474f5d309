"""The port's count encoder (mmvae_tpu_torch/ops/enc_kernel.py) against
the JAX package's, forward and weight VJP: the XLA spec ``_xla_encode``
and the Pallas kernels in interpret mode.

Tolerance: the only difference is float32 reassociation of the D-term
sums, so every comparison is scaled by the sum of the terms' magnitudes,
``S = |log1p x| @ |WL|^T`` (``|x| @ |WX|^T`` for hX):
``|port - jax| <= 1e-5 * S + 1e-6``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mmvae_tpu.ops.enc_kernel as jek
from mmvae_tpu_torch.ops import enc_kernel as tek

DTYPES = {"int8": np.int8, "int16": np.int16, "float32": np.float32}


def _inputs(M, D, r1, r2, dtype, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == "float32":
        x = rng.gamma(1.0, 2.0, size=(M, D)).astype(np.float32)
    else:
        hi = 127 if dtype == "int8" else 3000
        x = rng.poisson(1.5, size=(M, D))
        spikes = rng.random((M, D)) < 0.01
        x[spikes] = rng.integers(0, hi + 1, size=int(spikes.sum()))
        x = x.astype(DTYPES[dtype])
    WL = (rng.normal(size=(r1, D)) * 0.1).astype(np.float32)
    WX = (rng.normal(size=(r2, D)) * 0.01).astype(np.float32)
    return x, WL, WX


def _bounds(x, WL, WX):
    xf = x.astype(np.float64)
    return (np.abs(np.log1p(xf)) @ np.abs(WL.T).astype(np.float64),
            np.abs(xf) @ np.abs(WX.T).astype(np.float64))


def assert_close_scaled(got, want, S):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want)
    lim = 1e-5 * S + 1e-6
    assert np.all(err <= lim), f"max err/limit {np.max(err / lim):.3g}"


def _port(x, WL, WX):
    hL, hX = tek.count_encode(torch.from_numpy(x), torch.from_numpy(WL),
                              torch.from_numpy(WX) if len(WX) else None)
    return hL.numpy(), hX.numpy()


CASES = pytest.mark.parametrize("dtype", list(DTYPES))
WIDTHS = pytest.mark.parametrize("D", [1000, 2100])
R2 = pytest.mark.parametrize("r2", [2, 0])


@CASES
@WIDTHS
@R2
def test_count_encode_matches_xla_spec(dtype, D, r2):
    x, WL, WX = _inputs(13, D, 3, r2, dtype)
    eL, eX, _ = jek._xla_encode(jnp.asarray(x), jnp.asarray(WL),
                                jnp.asarray(WX), None, False)
    hL, hX = _port(x, WL, WX)
    SL, SX = _bounds(x, WL, WX)
    assert_close_scaled(hL, eL, SL)
    assert_close_scaled(hX, eX, SX)


@CASES
@WIDTHS
@R2
def test_count_encode_matches_pallas_interpret(monkeypatch, dtype, D, r2):
    monkeypatch.setattr(jek, "_INTERPRET", True)
    x, WL, WX = _inputs(13, D, 3, r2, dtype, seed=1)
    eL, eX, _ = jek.count_encode(jnp.asarray(x), jnp.asarray(WL),
                                 jnp.asarray(WX), None, False)
    hL, hX = _port(x, WL, WX)
    SL, SX = _bounds(x, WL, WX)
    assert_close_scaled(hL, eL, SL)
    assert_close_scaled(hX, eX, SX)


def test_cpu_call_counts_no_launch():
    x, WL, WX = _inputs(5, 300, 2, 2, "int8")
    before = tek.count_encode.launches
    _port(x, WL, WX)
    assert tek.count_encode.launches == before


def test_kernel_route_refuses_grad_weights():
    """The raw kernel route records no graph: called directly with
    weights that require grad it raises (gradients go through
    ``count_encode``, whose backward is K5) instead of returning an output
    without gradient.  Checked on the validation seam, which runs before
    any CUDA call."""
    x, WL, WX = _inputs(4, 64, 2, 1, "int8")
    wl = torch.from_numpy(WL).requires_grad_()
    with pytest.raises(NotImplementedError, match="K5"):
        tek._kernel_route(torch.from_numpy(x), wl, torch.from_numpy(WX))
    with torch.no_grad():  # without grad mode the check passes
        tek._check_kernel_args(torch.from_numpy(x), wl, None)


@pytest.mark.parametrize("bad", ["dtype", "width", "rank", "empty"])
def test_kernel_route_validates_arguments(bad):
    x, WL, WX = _inputs(4, 64, 2, 1, "int8")
    x, WL, WX = map(torch.from_numpy, (x, WL, WX))
    if bad == "dtype":
        x = x.to(torch.int32)
    elif bad == "width":
        WL = WL[:, :32].contiguous()
    elif bad == "rank":
        x = x[None]
    else:
        WL, WX = WL[:0], None
    with pytest.raises((TypeError, ValueError)):
        tek._check_kernel_args(x, WL, WX)



# ----------------------------------------------------------------------
# the forward kernel's launch plan (count_encode.cu: D tiles of FWD_TILE
# columns, a (tiles, M, width) workspace of per-tile row partials)
# ----------------------------------------------------------------------

INSTANCES = pytest.mark.parametrize("stats,filt", [(False, False),
                                                   (True, False),
                                                   (True, True)],
                                    ids=["K4", "K4s", "K4f"])


@INSTANCES
@pytest.mark.parametrize("D", [1, 255, 256, 257, 1003, 20000])
def test_fwd_plan_depends_on_d_and_instance_only(D, stats, filt):
    """The tiles and partials of every launch follow from D and the
    instance alone: no M (and no dtype: the plan takes neither) moves
    them, so a row's sums are grouped the same in every launch."""
    plans = {}
    for M in (0, 1, 37, 100, 1600):
        for r1, r2 in ((2, 2), (5, 3), (12, 3), (22, 3), (2, 0), (5, 10)):
            plan = tek.fwd_plan(D, r1, r2, stats, filt)
            plans.setdefault((r1, r2), plan)
            assert plan == plans[(r1, r2)]
            for p in plan:
                assert p.tiles == -(-D // tek.FWD_TILE)
                assert (p.tiles - 1) * tek.FWD_TILE < D <= (
                    p.tiles * tek.FWD_TILE)
                assert p.workspace(M) == (p.tiles, M, p.width)


@INSTANCES
@pytest.mark.parametrize("r1,r2", [(1, 0), (2, 2), (5, 3), (12, 1),
                                   (12, 3), (16, 4), (22, 3), (24, 2),
                                   (0, 3), (5, 10), (40, 0)])
def test_fwd_plan_covers_every_row_once(r1, r2, stats, filt):
    """Launch i takes WL rows [16 i, 16 i + 16) and WX rows [4 i, 4 i + 4),
    so every row lands in one launch, within the kernel's register
    bounds; the stats (and the filter) ride the first launch only, and a
    launch's width is its rows plus its stats."""
    plan = tek.fwd_plan(20000, r1, r2, stats, filt)
    assert [(p.l0, p.l1) for p in plan if p.l1 > p.l0] == [
        (a, min(a + 16, r1)) for a in range(0, r1, 16)]
    assert [(p.x0, p.x1) for p in plan if p.x1 > p.x0] == [
        (a, min(a + 4, r2)) for a in range(0, r2, 4)]
    assert len(plan) == max(-(-r1 // 16), -(-r2 // 4))
    for i, p in enumerate(plan):
        assert p.l1 - p.l0 <= tek.MAX_ROWS_PER_LAUNCH
        assert p.x1 - p.x0 <= tek.MAX_X_ROWS_PER_LAUNCH
        assert 0 < p.l1 - p.l0 + p.x1 - p.x0
        assert (p.stats, p.filt) == ((stats, filt) if i == 0
                                     else (False, False))
        ns = 4 if p.filt else 2 if p.stats else 0
        assert p.width == p.l1 - p.l0 + p.x1 - p.x0 + ns


@INSTANCES
@pytest.mark.parametrize("M", [1, 37])
@pytest.mark.parametrize("D", [255, 256, 257])
def test_count_encode_tile_edges_match_xla_spec(D, M, stats, filt):
    """All three forward instances at D on either side of the kernel's
    tile width and at row counts off its 32-row groups, against the XLA
    spec (the stats' tolerance: 1e-5 * stat + 1e-6)."""
    x, WL, WX = _inputs(M, D, 12 if filt else 5, 3, "int16", seed=D + M)
    f = ((np.random.default_rng(D).random((1, D)) < 0.25).astype(np.float32)
         if filt else None)
    want = jek._xla_encode(jnp.asarray(x), jnp.asarray(WL), jnp.asarray(WX),
                           None if f is None else jnp.asarray(f), stats)
    got = tek.count_encode(torch.from_numpy(x), torch.from_numpy(WL),
                           torch.from_numpy(WX), want_stats=stats,
                           filt=None if f is None else torch.from_numpy(f))
    SL, SX = _bounds(x, WL, WX)
    assert_close_scaled(got[0].numpy(), want[0], SL)
    assert_close_scaled(got[1].numpy(), want[1], SX)
    if stats:
        st = np.asarray(want[2], np.float64)
        assert got[2].shape == (M, 4)
        assert_close_scaled(got[2].numpy(), st, np.abs(st))


# ----------------------------------------------------------------------
# backward (K5): the weight VJP, same scaled tolerance with
# S = |g1|^T |log1p x| (|g2|^T |x| for dWX)
# ----------------------------------------------------------------------

@CASES
@pytest.mark.parametrize("interpret", [False, True])
def test_count_encode_vjp_matches_jax(monkeypatch, dtype, interpret):
    """The port's autograd of ``count_encode`` (plain backward on the CPU)
    against ``jax.vjp`` of the JAX op: its XLA spec, or its Pallas
    backward kernel in interpret mode."""
    monkeypatch.setattr(jek, "_INTERPRET", interpret)
    x, WL, WX = _inputs(13, 1000, 3, 2, dtype, seed=2)
    rng = np.random.default_rng(7)
    g1 = rng.normal(size=(13, 3)).astype(np.float32)
    g2 = rng.normal(size=(13, 2)).astype(np.float32)
    _, vjp = jax.vjp(lambda wl, wx: jek.count_encode(
        jnp.asarray(x), wl, wx, None, False)[:2], jnp.asarray(WL),
        jnp.asarray(WX))
    eL, eX = vjp((jnp.asarray(g1), jnp.asarray(g2)))
    wl = torch.from_numpy(WL).requires_grad_()
    wx = torch.from_numpy(WX).requires_grad_()
    hL, hX = tek.count_encode(torch.from_numpy(x), wl, wx)
    torch.autograd.backward([hL, hX], [torch.from_numpy(g1),
                                       torch.from_numpy(g2)])
    xf = x.astype(np.float64)
    assert_close_scaled(wl.grad.numpy(), eL,
                        np.abs(g1.T).astype(np.float64) @ np.log1p(xf))
    assert_close_scaled(wx.grad.numpy(), eX,
                        np.abs(g2.T).astype(np.float64) @ np.abs(xf))


@pytest.mark.parametrize("r1,r2", [(2, 2), (5, 3), (12, 3)])
@pytest.mark.parametrize("D", [255, 256, 257])
def test_count_encode_vjp_tile_edges_match_pallas_interpret(monkeypatch, D,
                                                            r1, r2):
    """The plain backward (K5's reference on the card) against the JAX
    op's Pallas backward kernel (``_bwd_call``, interpret mode) at the D
    tile edges, at the trainers' widths (NB, joint, mixture)."""
    monkeypatch.setattr(jek, "_INTERPRET", True)
    x, WL, WX = _inputs(37, D, r1, r2, "int16", seed=5)
    rng = np.random.default_rng(D + r1)
    g1 = rng.normal(size=(37, r1)).astype(np.float32)
    g2 = rng.normal(size=(37, r2)).astype(np.float32)
    _, vjp = jax.vjp(lambda wl, wx: jek.count_encode(
        jnp.asarray(x), wl, wx, None, False)[:2], jnp.asarray(WL),
        jnp.asarray(WX))
    eL, eX = vjp((jnp.asarray(g1), jnp.asarray(g2)))
    dWL, dWX = tek.count_encode_bwd_ref(torch.from_numpy(x),
                                        torch.from_numpy(g1),
                                        torch.from_numpy(g2))
    xf = x.astype(np.float64)
    assert_close_scaled(dWL.numpy(), eL,
                        np.abs(g1.T).astype(np.float64) @ np.log1p(xf))
    assert_close_scaled(dWX.numpy(), eX,
                        np.abs(g2.T).astype(np.float64) @ np.abs(xf))


def test_bwd_plain_version_is_autograd_of_forward():
    x, WL, WX = _inputs(6, 300, 2, 2, "int16", seed=4)
    g1, g2 = torch.randn(6, 2), torch.randn(6, 2)
    wl = torch.from_numpy(WL).requires_grad_()
    wx = torch.from_numpy(WX).requires_grad_()
    hL, hX = tek.count_encode_ref(torch.from_numpy(x), wl, wx)
    dWL, dWX = torch.autograd.grad([hL, hX], [wl, wx], [g1, g2])
    eL, eX = tek.count_encode_bwd_ref(torch.from_numpy(x), g1, g2)
    torch.testing.assert_close(eL, dWL)
    torch.testing.assert_close(eX, dWX)
    before = tek.count_encode_bwd.launches
    tek.count_encode_bwd(torch.from_numpy(x), g1, None)
    assert tek.count_encode_bwd.launches == before  # CPU: plain version


# ----------------------------------------------------------------------
# chip_smoke.py phase 1: every count_encode.cu instance's registers and
# spills read from ptxas' report, and a spill fails the build phase
# ----------------------------------------------------------------------

_ENTRY = ("ptxas info    : Compiling entry function '_ZN48_GLOBAL__N__11bf2b74"
          "_15_count_encode_cu_4cdaf3a9{name}' for 'sm_90a'\n"
          "ptxas info    : Function properties for _ZN{name}\n"
          "    0 bytes stack frame, {spill} bytes spill stores, {spill} bytes "
          "spill loads\n"
          "ptxas info    : Used {regs} registers, used 1 barriers\n")


def _build_log(spill=0):
    body = "".join(_ENTRY.format(name=n, spill=b, regs=r) for n, b, r in (
        ("18count_encode_tilesIaLi16ELi4ELb0ELb0EEEvPKT_llPKfiS5_iS5_Pf",
         0, 128),
        ("18count_encode_tilesIsLi2ELi0ELb1ELb0EEEvPKT_llPKfiS5_iS5_Pf",
         0, 51),
        ("18count_encode_tilesIfLi16ELi0ELb1ELb1EEEvPKT_llPKfiS5_iS5_Pf",
         spill, 128),
        ("16count_encode_sumEPKflliiibPflS2_lS2_", 0, 30)))
    other = _ENTRY.format(name="8nb_lse", spill=16, regs=40)
    return f"== count_encode.cu\n{body}== nb_lse.cu\n{other}"


def test_encode_instances_reads_every_instance():
    import chip_smoke

    assert chip_smoke.check_instances(
        _build_log(), "count_encode.cu", chip_smoke.encode_label) == [
        ("int8 16+4", 128, 0), ("int16 2+0+stats", 51, 0),
        ("f32 16+0+filt", 128, 0), ("sum", 30, 0)]


@pytest.mark.parametrize("log", [_build_log(spill=8), "== nb_lse.cu\n"],
                         ids=["spill", "no_instance"])
def test_encode_instances_spill_fails_phase_1(log):
    import chip_smoke

    with pytest.raises(AssertionError, match="count_encode.cu"):
        chip_smoke.check_instances(log, "count_encode.cu",
                                   chip_smoke.encode_label)
