"""The port's fused step (mmvae_tpu_torch/ops/nb_step.py) against the JAX
package's: the XLA spec ``xla_step_nll`` with ``jax.grad``, and the
Pallas kernels in interpret mode (``nb_step_report``,
``nb_step_boot_gradonly`` and the raw kernel outputs).

On the CPU every wrapper runs its plain version, so these tests hold the
plain versions and the gradient assembly of ``nb_step_boot_gradonly``
against JAX; the CUDA kernels are held against the same plain versions
on the card by ``chip_smoke.py``.

Tolerances, the JAX suite's own (tests/test_nb_step.py): values
``rtol=3e-5`` (float32 reassociation of a sum over B x D terms);
gradients ``rtol=5e-4, atol=5e-6 * max|ref|`` (the Pallas kernels use
the shift-into-Stirling lgamma / digamma and one shared reciprocal, the
plain version exact float32 ``lgamma`` / ``digamma``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmvae_tpu.ops import nb_step as jns
from mmvae_tpu_torch.ops import enc_kernel as tek
from mmvae_tpu_torch.ops import nb_step as tns

# (counts, storage): all <= 7 (select-product tiles), integers up to 40
# (the mixed product / Stirling tiles), non-integer (Stirling tiles)
CASES = [("le7", np.float32), ("integer", np.float32),
         ("nonint", np.float32), ("le7", np.int8), ("integer", np.int16)]
DIFF = (1, 3, 4, 5, 6, 7, 8, 9)  # zm, zn, depth, wd, wc, bias2, wn, bias_n
NAMES = ["zm", "zn", "depth", "wd", "wc", "bias2", "wn", "bias_n"]


def _inputs(regime, dtype, B=10, D=1100, seed=0):
    rng = np.random.default_rng(seed)
    if regime == "le7":
        x = rng.poisson(0.8, size=(B, D)).clip(0, 6).astype(np.float32)
    elif regime == "integer":
        x = rng.poisson(9.0, size=(B, D)).clip(0, 40).astype(np.float32)
    else:
        x = rng.poisson(0.8, size=(B, D)).astype(np.float32)
        x[0, :7] += 0.5
    x = x.astype(dtype)
    zm = rng.normal(size=(B, 2)).astype(np.float32)
    c = rng.normal(size=(B, 1)).astype(np.float32)
    zn = rng.normal(size=(B, 1)).astype(np.float32)
    depth = (np.abs(rng.normal(size=(B, 1))) + 0.3).astype(np.float32)
    w = [(rng.normal(size=s) * 0.2).astype(np.float32)
         for s in ((2, D), (1, D), (D,), (1, D), (D,))]
    return [x, zm, c, zn, depth, *w]


def _jax(args):
    return [jnp.asarray(a) for a in args]


def _torch(args, grad=False):
    out = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
    if grad:
        for i in DIFF:
            out[i].requires_grad_()
    return out


def _assert_grads(got, want):
    for name, a, b in zip(NAMES, got, want):
        b = np.asarray(b)
        scale = max(1e-3, float(np.abs(b).max()))
        np.testing.assert_allclose(a.detach().numpy(), b, rtol=5e-4,
                                   atol=5e-6 * scale,
                                   err_msg=f"grad mismatch: {name}")


def _jax_grads(fn, args):
    def loss(*d):
        a = list(_jax(args))
        for i, v in zip(DIFF, d):
            a[i] = v
        return fn(*a)

    d = tuple(jnp.asarray(args[i]) for i in DIFF)
    return jax.value_and_grad(loss, argnums=tuple(range(len(DIFF))))(*d)


@pytest.mark.parametrize("include_const", [False, True])
@pytest.mark.parametrize("regime,dtype", CASES)
def test_step_nll_matches_xla_spec(regime, dtype, include_const):
    args = _inputs(regime, dtype)
    v, g = _jax_grads(lambda *a: jns.xla_step_nll(
        *a, include_const=include_const), args)
    targs = _torch(args, grad=True)
    got = tns.step_nll_ref(*targs, include_const=include_const)
    np.testing.assert_allclose(float(got.detach()), float(v), rtol=3e-5)
    got.backward()
    _assert_grads([targs[i].grad for i in DIFF], g)


PALLAS = [("le7", np.float32), ("integer", np.int16), ("nonint", np.float32)]


@pytest.mark.parametrize("regime,dtype", PALLAS)
def test_report_matches_pallas_interpret(monkeypatch, regime, dtype):
    monkeypatch.setattr(jns, "_INTERPRET", True)
    args = _inputs(regime, dtype, seed=1)
    want = jns.nb_step_report(*_jax(args), include_const=True)
    got = tns.nb_step_report(*_torch(args), include_const=True)
    np.testing.assert_allclose(float(got), float(want), rtol=3e-5)


@pytest.mark.parametrize("regime,dtype", PALLAS)
def test_boot_gradonly_matches_pallas_interpret(monkeypatch, regime, dtype):
    monkeypatch.setattr(jns, "_INTERPRET", True)
    args = _inputs(regime, dtype, seed=2)
    v, g = _jax_grads(jns.nb_step_boot_gradonly, args)
    targs = _torch(args, grad=True)
    got = tns.nb_step_boot_gradonly(*targs)
    assert float(got.detach()) == 0.0 == float(v)  # the grad-only primal
    (got * 1.5).backward()  # the backward scales by the cotangent
    _assert_grads([targs[i].grad / 1.5 for i in DIFF], g)


def test_raw_kernel_outputs_match_pallas_interpret(monkeypatch):
    """Each plain version's raw outputs against its Pallas kernel's:
    K1 lse, K2 (gout, rsum, u1, dzn), K3 (fout, u2)."""
    monkeypatch.setattr(jns, "_INTERPRET", True)
    args = _inputs("integer", np.int16, B=9, D=1100, seed=3)
    x, zm, c, zn, depth, wd, wc, bias2, wn, bias_n = _jax(args)
    xp, zmp, cp, znp, dpp, W, dims = jns._prep(
        x, zm, c, zn, depth, wd, wc, bias2, wn, bias_n)
    B, D, R, C, Rn = (dims[k] for k in ("B", "D", "R", "C", "Rn"))
    l = jns._lse_call(zmp, cp, W, dims["bp"], dims["Dp"],
                      jns._tile_for(dims["bp"]), D, R, C)
    _, gout, rsum, u1, dzn = jns._valgrad_call(
        xp, zmp, cp, znp, dpp, l, W, D=D, B=B, need_value=False)
    fout, u2 = jns._finish_call(zmp, cp, l, rsum, W, D=D)

    t = _torch(args)
    zc = torch.cat([t[1], t[2]], 1)
    Wt = tns.stack_rows(*t[5:])
    lt = tns.lse(zc, Wt, R, C)
    np.testing.assert_allclose(lt.numpy(), np.asarray(l)[:B], rtol=1e-6)
    got = tns.valgrad(t[0], zc, t[3], t[4], lt, Wt, R, C, Rn)
    fin = tns.finish(zc, lt, got[1].contiguous(), Wt, R, C)
    T = R + C + Rn + 2
    want = [np.asarray(gout)[:T, :D], np.asarray(rsum)[:B],
            np.asarray(u1)[:B], np.asarray(dzn)[:B],
            np.asarray(fout)[:R + C + 1, :D], np.asarray(u2)[:B]]
    for name, a, b in zip(["gout", "rsum", "u1", "dzn", "fout", "u2"],
                          [*got, *fin], want):
        scale = max(1e-3, float(np.abs(b).max()))
        np.testing.assert_allclose(a.numpy(), b, rtol=5e-4,
                                   atol=5e-6 * scale, err_msg=name)


@pytest.mark.parametrize("R,C", [(2, 1), (4, 2)])
@pytest.mark.parametrize("D", [255, 256, 257])
def test_lse_tile_edges_match_pallas_interpret_and_xla(monkeypatch, D, R, C):
    """The plain K1 (its reference on the card) against the JAX
    package's: its Pallas kernel (``_lse_call``, interpret mode) and the
    XLA spec's normaliser (``xla_step_nll``'s logits), at the D tile
    edges, at the trainers' widths (2, 1) and a general one."""
    monkeypatch.setattr(jns, "_INTERPRET", True)
    rng = np.random.default_rng(D + R)
    B = 9
    x = rng.poisson(2.0, size=(B, D)).astype(np.int16)
    zm = rng.normal(size=(B, R)).astype(np.float32)
    c = rng.normal(size=(B, C)).astype(np.float32)
    zn = rng.normal(size=(B, 1)).astype(np.float32)
    depth = np.ones((B, 1), np.float32)
    w = [(rng.normal(size=s) * 0.3).astype(np.float32)
         for s in ((R, D), (C, D), (D,), (1, D), (D,))]
    xp, zmp, cp, _, _, W, dims = jns._prep(*_jax([x, zm, c, zn, depth, *w]))
    want = np.asarray(jns._lse_call(
        zmp, cp, W, dims["bp"], dims["Dp"], jns._tile_for(dims["bp"]), D, R,
        C))[:B]
    h = jnp.asarray(zm) @ w[0] + jnp.asarray(c) @ w[1] + w[2]
    xla = np.asarray(jax.nn.logsumexp(h, axis=1, keepdims=True))
    t = _torch([zm, c, *w])
    got = tns.lse_ref(torch.cat([t[0], t[1]], 1), tns.stack_rows(*t[2:]), R,
                      C).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(got, xla, rtol=1e-6)


def test_cpu_wrappers_launch_no_kernel():
    args = _torch(_inputs("le7", np.int8, B=4, D=64))
    before = [f.launches for f in (tns.lse, tns.value, tns.valgrad,
                                   tns.finish)]
    tns.nb_step_report(*args)
    tns.nb_step_boot_gradonly(*args)
    assert [f.launches for f in (tns.lse, tns.value, tns.valgrad,
                                 tns.finish)] == before


@pytest.mark.parametrize("kernel", ["lse", "value", "valgrad", "finish",
                                    "count_encode_bwd"])
def test_kernel_routes_refuse_cpu_tensors(kernel):
    """The kernel routes take CUDA tensors only: a CPU tensor there
    raises before any CUDA call (the public wrappers send CPU tensors to
    the plain versions instead)."""
    x, zm, c, zn, depth, *w = _torch(_inputs("le7", np.int8, B=4, D=64))
    zc = torch.cat([zm, c], 1)
    W = tns.stack_rows(*w)
    l = tns.lse_ref(zc, W, 2, 1)
    call = {
        "lse": lambda: tns._lse_kernel(zc, W, 2, 1),
        "value": lambda: tns._value_kernel(x, zc, zn, depth, l, W, 2, 1, 1,
                                           True),
        "valgrad": lambda: tns._valgrad_kernel(x, zc, zn, depth, l, W, 2, 1,
                                               1),
        "finish": lambda: tns._finish_kernel(zc, l, l, W, 2, 1),
        "count_encode_bwd": lambda: tek._bwd_kernel_route(x, zm, zn),
    }[kernel]
    with pytest.raises(ValueError, match="no kernel"):
        call()


def test_kernel_routes_refuse_unsupported_widths():
    """Any width the reference trains has a plan on the general instance
    (T = 18 here, past the 16 stacked rows the port once took); what
    stays refused: latents that do not match the widths, and widths past
    the card's shared memory a block, whose refusal names the limit."""
    x, zm, c, zn, depth, *w = _torch(_inputs("le7", np.int8, B=4, D=64))
    zc = torch.cat([zm, c], 1)
    W = tns.stack_rows(*w)
    assert tns._dims(zc, W, 2, 1) == (4, 64)
    for plan in (tns.valgrad_plan(4, 64, 2, 1, 13),
                 tns.value_plan(4, 64, 2, 1, 13),
                 tns.finish_plan(4, 64, 2, 14)):
        assert plan.instance == "general"
    with pytest.raises(ValueError, match="stacked rows"):
        tns.valgrad_plan(4, 64, 2, 1, tns.MAX_STACKED_ROWS["valgrad"])
    with pytest.raises(ValueError, match="do not match"):
        tns._dims(zm, W, 2, 1)


# ----------------------------------------------------------------------
# K2's launch plan (valgrad_plan): the instance by the widths, the tile
# and the chunking by (B, D) alone; the C entry checks the plan on the
# card (chip_smoke.py phase 28 launches every case below)
# ----------------------------------------------------------------------

PLAN_BS = (1, 37, 100, 1600)
PLAN_DS = (255, 256, 257, 1003, 20000)


def _cli_valgrad_calls(monkeypatch, tmp_path):
    """(B, D, R, C, Rn, joint, need_value) of every K2 call the trainer
    CLIs make at their defaults (NB, joint, labeled mixture) and on the
    NB generic route with a hidden encoder, one epoch each on the CPU."""
    from mmvae_tpu.io.writers import write_matrix_market_file
    from mmvae_tpu_torch.cli import nb_vae, vmfnb_vae

    calls, plain = [], tns.valgrad_ref

    def spy(x, zc, zn, depth, lse, W, R, C, Rn, joint=False,
            need_value=False):
        calls.append((*x.shape, R, C, Rn, bool(joint), bool(need_value)))
        return plain(x, zc, zn, depth, lse, W, R, C, Rn, joint, need_value)

    monkeypatch.setattr(tns, "valgrad_ref", spy)
    D, N = 30, 40
    rng = np.random.default_rng(9)
    dens = rng.poisson(1.5, size=(D, N)).astype(np.float32)
    dens[0, ~(dens > 0).any(axis=0)] = 1.0
    rr, cc = np.nonzero(dens)
    mtx = str(tmp_path / "m.mtx.gz")
    write_matrix_market_file(mtx, rr, cc, dens[rr, cc], (D, N))
    (tmp_path / "rows.txt").write_text("".join(f"g{i}\n" for i in range(D)))
    (tmp_path / "annot.txt").write_text(
        "".join(f"g{i} T{i % 3}\n" for i in range(12)))
    common = ["--mtx", mtx, "--batch_size", "20", "--max_epoch", "1",
              "--device", "cpu"]
    runs = [(nb_vae, []), (nb_vae, ["--mean_encoding", "4"]),
            (vmfnb_vae, []),
            (vmfnb_vae, ["--annot", str(tmp_path / "annot.txt"), "--row",
                         str(tmp_path / "rows.txt")])]
    for i, (cli, extra) in enumerate(runs):
        assert cli.main(common + extra + ["--out",
                                          str(tmp_path / f"o{i}")]) == 0
    return calls


def test_valgrad_plan_cli_shapes_take_the_compile_time_instance(
        monkeypatch, tmp_path):
    calls = _cli_valgrad_calls(monkeypatch, tmp_path)
    assert {c[-2] for c in calls} == {False, True}  # NB and joint K2
    for B, D, R, C, Rn, joint, nv in calls:
        assert (R, C, Rn) == tns.VALGRAD_FIXED
        assert tns.valgrad_plan(B, D, R, C, Rn, joint, nv).instance == "fixed"


@pytest.mark.parametrize("widths", [(4, 2, 3), (1, 0, 1), (2, 0, 1),
                                    (2, 1, 2), (3, 1, 1), (8, 2, 3)])
def test_valgrad_plan_other_widths_take_the_general_instance(widths):
    for B in PLAN_BS:
        for D in PLAN_DS:
            for joint in (False, True):
                plan = tns.valgrad_plan(B, D, *widths, joint)
                assert plan.instance == "general"
                assert plan.tiles == -(-D // tns.VALGRAD_TILE)


@pytest.mark.parametrize("B", PLAN_BS)
def test_valgrad_plan_tiles_and_chunks_depend_on_B_and_D_alone(B):
    """One tiling and chunking for every width, variant and (no dtype
    argument) storage; the workspace is the row partials, the chunks'
    column partials and the value partials of that plan."""
    for D in PLAN_DS:
        layouts = set()
        for R, C, Rn in ((2, 1, 1), (4, 2, 3), (1, 0, 1)):
            for joint in (False, True):
                for nv in (False, True):
                    p = tns.valgrad_plan(B, D, R, C, Rn, joint, nv)
                    layouts.add((p.tile, p.tiles, p.chunks, p.grid))
                    assert p.row_parts == (1 + R + Rn) * p.tiles * B
                    assert p.col_parts == (
                        p.chunks * (R + C + Rn + 2) * D if p.chunks > 1
                        else 0)
                    assert p.value_parts == (
                        p.chunks * p.tiles * tns.VALGRAD_WARPS if nv else 0)
                    assert p.workspace == (p.row_parts + p.col_parts
                                           + p.value_parts)
        (layout,) = layouts
        tile, tiles = layout[0], layout[1]
        assert tile == tns.VALGRAD_TILE and tiles * tile >= D > (
            tiles - 1) * tile
        assert 1 <= layout[2] <= min(B, tns.VALGRAD_MAX_CHUNKS)
        assert layout[3] == (layout[1], layout[2])


def test_valgrad_plan_chunks():
    """ceil(B / 20) row chunks, at most 8: the main path's B = 100 takes
    5 (1,565 blocks at D = 20,000)."""
    assert [tns.valgrad_plan(B, 20000, 2, 1, 1).chunks
            for B in (1, 20, 21, 37, 100, 140, 141, 1600)] == [
        1, 1, 2, 2, 5, 7, 8, 8]
    p = tns.valgrad_plan(100, 20000, 2, 1, 1)
    assert (p.tiles, p.chunks) == (313, 5)


@pytest.mark.parametrize("bad", [(2, 1, 13), (0, 1, 1), (2, 1, 0),
                                 (2, -1, 1)])
def test_valgrad_plan_refuses_unsupported_widths(bad):
    """R = 0, Rn = 0 and C < 0 stay refused; (2, 1, 13) (T = 18) and the
    joint (2, 1, 11) (T = 17), which the port once refused, take the
    general instance; past the card's shared memory a block is refused
    with the limit named."""
    R, C, Rn = bad
    if R >= 1 and C >= 0 and Rn >= 1:
        assert tns.valgrad_plan(10, 100, *bad).instance == "general"
    else:
        with pytest.raises(ValueError, match="stacked rows"):
            tns.valgrad_plan(10, 100, *bad)
    assert tns.valgrad_plan(10, 100, 2, 1, 11,
                            joint=True).instance == "general"  # T = 17
    with pytest.raises(ValueError, match="at most 181 stacked rows"):
        tns.valgrad_plan(10, 100, 2, 1, 200)
    with pytest.raises(ValueError, match="empty"):
        tns.valgrad_plan(0, 100, 2, 1, 1)


# ----------------------------------------------------------------------
# K6's and K3's launch plans (value_plan, finish_plan): K2's tiles, each
# kernel's own chunking by B alone, the instance by the widths
# (chip_smoke.py phase 30 launches every case below)
# ----------------------------------------------------------------------

@pytest.mark.parametrize("B", PLAN_BS)
def test_value_plan_tiles_and_chunks_depend_on_B_and_D_alone(B):
    """One tiling and chunking for every width and variant; the workspace
    is one value partial a warp of every (chunk, tile) block."""
    for D in PLAN_DS:
        layouts = set()
        for R, C, Rn in ((2, 1, 1), (4, 2, 3), (1, 0, 1), (13, 1, 1)):
            for joint in (False, True):
                p = tns.value_plan(B, D, R, C, Rn, joint)
                layouts.add((p.tile, p.tiles, p.chunks, p.grid))
                assert (p.row_parts, p.col_parts) == (0, 0)
                assert p.workspace == p.value_parts == (
                    p.chunks * p.tiles * tns.VALGRAD_WARPS)
        (layout,) = layouts
        tile, tiles, chunks, grid = layout
        assert tile == tns.VALGRAD_TILE and tiles * tile >= D > (
            tiles - 1) * tile
        assert 1 <= chunks <= min(B, tns.VALUE_MAX_CHUNKS)
        assert grid == (tiles, chunks)


@pytest.mark.parametrize("B", PLAN_BS)
def test_finish_plan_tiles_and_chunks_depend_on_B_and_D_alone(B):
    """One tiling and chunking for every (R, C); the workspace is u2's
    row partials (R, tiles, B) and, with more than one chunk, the
    chunks' partials of fout's R + C + 1 rows."""
    for D in PLAN_DS:
        layouts = set()
        for R, C in ((2, 1), (4, 2), (1, 0), (13, 1), (2, 12)):
            p = tns.finish_plan(B, D, R, C)
            layouts.add((p.tile, p.tiles, p.chunks, p.grid))
            assert p.row_parts == R * p.tiles * B
            assert p.col_parts == (p.chunks * (R + C + 1) * D
                                   if p.chunks > 1 else 0)
            assert p.value_parts == 0
        (layout,) = layouts
        tile, tiles, chunks, grid = layout
        assert tile == tns.VALGRAD_TILE and tiles * tile >= D > (
            tiles - 1) * tile
        assert 1 <= chunks <= min(B, tns.FINISH_MAX_CHUNKS)
        assert grid == (tiles, chunks)


def test_value_and_finish_plan_chunks():
    """K6: ceil(B / 20) row chunks, at most 8 (5 at the main path's
    B = 100); K3: ceil(B / 50), at most 8 (2 at B = 100)."""
    Bs = (1, 20, 21, 37, 50, 51, 100, 140, 141, 1600)
    assert [tns.value_plan(B, 20000, 2, 1, 1).chunks for B in Bs] == [
        1, 1, 2, 2, 3, 3, 5, 7, 8, 8]
    assert [tns.finish_plan(B, 20000, 2, 1).chunks for B in Bs] == [
        1, 1, 1, 1, 1, 2, 2, 3, 3, 8]
    assert tns.value_plan(100, 20000, 2, 1, 1).grid == (313, 5)
    assert tns.finish_plan(100, 20000, 2, 1).grid == (313, 2)


@pytest.mark.parametrize("widths", [(2, 1, 1), (4, 2, 3), (1, 0, 1),
                                    (2, 0, 1), (2, 1, 2), (3, 1, 1),
                                    (13, 1, 1), (2, 123, 1)])
def test_value_and_finish_plan_instance_by_widths(widths):
    """K6's compile-time instance takes (2, 1, 1) alone; K3's (2, 1),
    whatever Rn (it reads no overdispersion rows); the general ones the
    rest, with their shared memory."""
    R, C, Rn = widths
    for B in PLAN_BS:
        for D in PLAN_DS:
            for joint in (False, True):
                p = tns.value_plan(B, D, R, C, Rn, joint)
                assert p.instance == ("fixed" if widths == (2, 1, 1)
                                      else "general")
                assert p.smem == (0 if p.instance == "fixed"
                                  else (R + C + Rn + 2) * 256)
            p = tns.finish_plan(B, D, R, C)
            assert p.instance == ("fixed" if (R, C) == (2, 1)
                                  else "general")
            assert p.smem == (0 if p.instance == "fixed"
                              else (R + C + 1) * 1280)


@pytest.mark.parametrize("bad", [(0, 1, 1), (2, -1, 1), (2, 1, 0)])
def test_value_and_finish_plan_refuse_bad_widths(bad):
    R, C, Rn = bad
    with pytest.raises(ValueError, match="stacked rows"):
        tns.value_plan(10, 100, *bad)
    if Rn >= 1:  # K3 takes no Rn
        with pytest.raises(ValueError, match="stacked rows"):
            tns.finish_plan(10, 100, R, C)
    with pytest.raises(ValueError, match="empty"):
        tns.value_plan(10, 0, 2, 1, 1)
    with pytest.raises(ValueError, match="empty"):
        tns.finish_plan(0, 100, 2, 1)


@pytest.mark.parametrize("widths", [(2, 1, 1), (3, 1, 2), (13, 1, 1)])
def test_value_and_finish_kernel_routes_refuse_cpu_tensors(widths):
    """A CPU tensor at K6's and K3's kernel routes raises whatever the
    plan's instance; the public wrappers take the plain versions and
    launch nothing."""
    R, C, Rn = widths
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.poisson(1.0, (5, 70)).astype(np.int8))
    zc = torch.from_numpy(rng.normal(size=(5, R + C)).astype(np.float32))
    zn = torch.from_numpy(rng.normal(size=(5, Rn)).astype(np.float32))
    depth = torch.ones((5, 1))
    W = torch.from_numpy(
        rng.normal(size=(R + C + Rn + 2, 70)).astype(np.float32))
    lse = tns.lse_ref(zc, W, R, C)
    with pytest.raises(ValueError, match="no kernel"):
        tns._value_kernel(x, zc, zn, depth, lse, W, R, C, Rn, True)
    with pytest.raises(ValueError, match="no kernel"):
        tns._finish_kernel(zc, lse, lse, W, R, C)
    before = (tns.value.launches, tns.finish.launches)
    tns.value(x, zc, zn, depth, lse, W, R, C, Rn)
    tns.finish(zc, lse, lse, W, R, C)
    assert (tns.value.launches, tns.finish.launches) == before


def test_valgrad_kernel_route_refuses_cpu_tensors_at_every_instance():
    """A CPU tensor at the kernel route raises whatever the plan's
    instance; the public wrapper takes the plain version instead."""
    for widths in ((2, 1, 1), (3, 1, 2)):
        R, C, Rn = widths
        rng = np.random.default_rng(1)
        x = torch.from_numpy(rng.poisson(1.0, (5, 70)).astype(np.int8))
        zc = torch.from_numpy(rng.normal(size=(5, R + C)).astype(np.float32))
        zn = torch.from_numpy(rng.normal(size=(5, Rn)).astype(np.float32))
        depth = torch.ones((5, 1))
        W = torch.from_numpy(
            rng.normal(size=(R + C + Rn + 2, 70)).astype(np.float32))
        lse = tns.lse_ref(zc, W, R, C)
        with pytest.raises(ValueError, match="no kernel"):
            tns._valgrad_kernel(x, zc, zn, depth, lse, W, R, C, Rn)
        before = tns.valgrad.launches
        tns.valgrad(x, zc, zn, depth, lse, W, R, C, Rn)
        assert tns.valgrad.launches == before


# chip_smoke.py phase 1 reads every nb_valgrad.cu instance's registers and
# spills from ptxas' report (the same reader as count_encode.cu's)
_VG_ENTRY = ("ptxas info    : Compiling entry function '_ZN48_GLOBAL__N__"
             "11bf2b74_13_nb_valgrad_cu_4cdaf3a9{name}' for 'sm_90a'\n"
             "ptxas info    : Function properties for _ZN{name}\n"
             "    0 bytes stack frame, {spill} bytes spill stores, {spill} "
             "bytes spill loads\n"
             "ptxas info    : Used {regs} registers, used 1 barriers\n")


def _vg_log(spill=0):
    body = "".join(_VG_ENTRY.format(name=n, spill=b, regs=r) for n, b, r in (
        ("13valgrad_tilesIaLi2ELi1ELi1ELb0ELb0EEEvPKT_PKfS5_S5_S5_S5_llii",
         0, 120),
        ("13valgrad_tilesIsLi0ELi0ELi0ELb1ELb1EEEvPKT_PKfS5_S5_S5_S5_llii",
         spill, 200),
        ("13valgrad_tilesIfLi2ELi1ELi1ELb1ELb0EEEvPKT_PKfS5_S5_S5_S5_llii",
         0, 110),
        ("11valgrad_sumEPKfS1_S1_llilii", 0, 24)))
    other = _VG_ENTRY.format(name="8nb_lse", spill=16, regs=40)
    return f"== nb_lse.cu\n{other}== nb_valgrad.cu\n{body}"


def test_valgrad_instances_read_by_phase_1():
    import chip_smoke

    assert chip_smoke.check_instances(
        _vg_log(), "nb_valgrad.cu", chip_smoke.valgrad_label) == [
        ("int8 2+1+1", 120, 0), ("int16 general+joint+value", 200, 0),
        ("f32 2+1+1+joint", 110, 0), ("sum", 24, 0)]
    with pytest.raises(AssertionError, match="nb_valgrad.cu instances spill"):
        chip_smoke.check_instances(_vg_log(spill=8), "nb_valgrad.cu",
                                   chip_smoke.valgrad_label)


# chip_smoke.py phase 1 reads every nb_value.cu and nb_finish.cu instance's
# registers and spills from ptxas' report (the same reader)
def _vf_log(spill=0):
    value = "".join(_VG_ENTRY.format(name=n, spill=b, regs=r) for n, b, r in (
        ("11value_tilesIaLi2ELi1ELi1ELb1ELb0EEEvPKT_PKfS5_S5_S5_S5_lliiiiiPf",
         0, 72),
        ("11value_tilesIfLi0ELi0ELi0ELb0ELb1EEEvPKT_PKfS5_S5_S5_S5_lliiiiiPf",
         spill, 68),
        ("9value_sumEPKflPf", 0, 31)))
    finish = "".join(_VG_ENTRY.format(name=n, spill=b, regs=r) for n, b, r in (
        ("12finish_tilesILi2ELi1EEEvPKfS2_S2_S2_lliiPfS3_S3_", 0, 47),
        ("12finish_tilesILi0ELi0EEEvPKfS2_S2_S2_lliiPfS3_S3_", spill, 56),
        ("10finish_sumEPKfS1_lliliillPfS2_", 0, 32)))
    return f"== nb_value.cu\n{value}== nb_finish.cu\n{finish}"


def test_value_and_finish_instances_read_by_phase_1():
    import chip_smoke

    assert chip_smoke.check_instances(
        _vf_log(), "nb_value.cu", chip_smoke.value_label) == [
        ("int8 2+1+1+const", 72, 0), ("f32 general+joint", 68, 0),
        ("sum", 31, 0)]
    assert chip_smoke.check_instances(
        _vf_log(), "nb_finish.cu", chip_smoke.finish_label) == [
        ("2+1", 47, 0), ("general", 56, 0), ("sum", 32, 0)]
    for source, label in (("nb_value.cu", chip_smoke.value_label),
                          ("nb_finish.cu", chip_smoke.finish_label)):
        with pytest.raises(AssertionError, match=f"{source} instances spill"):
            chip_smoke.check_instances(_vf_log(spill=8), source, label)
