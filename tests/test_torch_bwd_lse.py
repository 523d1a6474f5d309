"""Launch plans and kernel routes of the count encoder's backward (K5,
``enc_kernel.bwd_plan``) and the row logsumexp (K1, ``nb_step.lse_plan``).

On the CPU the wrappers run their plain versions, so these tests hold
what surrounds the CUDA kernels: the plans' tiling and chunking (by the
shape alone, every column and row covered once), the instance each
width takes (spied on the trainer CLIs' calls, as the K2 plan tests in
``tests/test_torch_nb_step.py`` do), the refusals of the kernel routes,
and ``chip_smoke.py`` phase 1's reader of the two sources' ptxas report.
``chip_smoke.py`` phase 29 launches every plan case below on the card.
"""

import numpy as np
import pytest

from mmvae_tpu_torch.ops import enc_kernel as tek
from mmvae_tpu_torch.ops import nb_step as tns

import torch

# phase 29's grid
MS = (1, 37, 100, 1600)
DS = (255, 256, 257, 1003, 20000)
BWD_WIDTHS = ((2, 2), (5, 3), (12, 3), (16, 0), (7, 9), (0, 3), (4, 2),
              (1, 0))
LSE_WIDTHS = ((2, 1), (4, 2), (15, 0), (1, 0), (2, 0), (3, 1))


# ----------------------------------------------------------------------
# K5: bwd_plan
# ----------------------------------------------------------------------

@pytest.mark.parametrize("M", MS)
def test_bwd_plan_tiles_and_chunks_depend_on_M_and_D_alone(M):
    """One tiling and chunking for every width (and, having no dtype
    argument, every storage); the tiles cover every column once, the
    chunks every row once; the workspace is the chunks' partials."""
    for D in DS:
        layouts = set()
        for r1, r2 in BWD_WIDTHS:
            p = tek.bwd_plan(M, D, r1, r2)
            layouts.add((p.tile, p.tiles, p.chunks, p.grid))
            assert p.workspace == (p.chunks * (r1 + r2) * D if p.chunks > 1
                                   else 0)
        (layout,) = layouts
        tile, tiles, chunks, grid = layout
        assert tile == tek.BWD_TILE and tiles * tile >= D > (tiles - 1) * tile
        assert grid == (tiles, chunks)
        assert 1 <= chunks <= min(M, tek.BWD_MAX_CHUNKS)
        rows = -(-M // chunks)  # the kernel's chunk: ceil(M / chunks) rows
        assert chunks * rows >= M > (chunks - 1) * rows


def test_bwd_plan_chunks():
    """ceil(M / 128) row chunks, at most 8: one at the trainers' B = 100,
    where stage 1 writes dWL / dWX and stage 2 does not run."""
    assert [tek.bwd_plan(M, 20000, 2, 2).chunks
            for M in (1, 100, 128, 129, 1000, 1024, 1025, 1600)] == [
        1, 1, 1, 2, 8, 8, 8, 8]
    p = tek.bwd_plan(100, 20000, 12, 3)
    assert (p.tiles, p.chunks, p.workspace) == (313, 1, 0)


@pytest.mark.parametrize("widths", BWD_WIDTHS)
def test_bwd_plan_instance_by_widths(widths):
    fixed = widths in ((2, 2), (5, 3), (12, 3))
    assert tuple(tek.BWD_FIXED) == ((2, 2), (5, 3), (12, 3))
    for M in MS:
        for D in DS:
            assert tek.bwd_plan(M, D, *widths).instance == (
                "fixed" if fixed else "general")


@pytest.mark.parametrize("bad", [(0, 0), (17, 0), (12, 5), (-1, 3),
                                 (2, -1)])
def test_bwd_plan_refuses_bad_widths(bad):
    with pytest.raises(ValueError, match="cotangent columns"):
        tek.bwd_plan(10, 100, *bad)


@pytest.mark.parametrize("M,D", [(0, 100), (10, 0)])
def test_bwd_plan_refuses_empty_operands(M, D):
    with pytest.raises(ValueError, match="empty"):
        tek.bwd_plan(M, D, 2, 2)


@pytest.mark.parametrize("r1,r2", [(2, 2), (16, 0), (0, 3), (16, 2),
                                   (18, 2), (30, 5)])
def test_bwd_groups_cover_every_slot_once(r1, r2):
    """K5's launches take the stacked slots [g1 | g2] 16 at a time."""
    groups = tek.bwd_groups(r1, r2)
    assert len(groups) == -(-(r1 + r2) // tek.MAX_ROWS_PER_LAUNCH)
    lcols, xcols = [], []
    for l0, l1, x0, x1 in groups:
        assert 1 <= (l1 - l0) + (x1 - x0) <= tek.MAX_ROWS_PER_LAUNCH
        lcols += range(l0, l1)
        xcols += range(x0, x1)
    assert lcols == list(range(r1)) and xcols == list(range(r2))


# ----------------------------------------------------------------------
# K1: lse_plan
# ----------------------------------------------------------------------

@pytest.mark.parametrize("B", MS)
def test_lse_plan_tiles_and_groups_depend_on_B_and_D_alone(B):
    """One tiling and row grouping for every width; the tiles cover every
    column once, the 32-row groups every row once; the workspace holds
    one (max, sum) pair per (tile, row)."""
    for D in DS:
        layouts = set()
        for R, C in LSE_WIDTHS:
            p = tns.lse_plan(B, D, R, C)
            layouts.add((p.tile, p.tiles, p.groups, p.grid))
            assert p.workspace == p.tiles * B * 2
        (layout,) = layouts
        tile, tiles, groups, grid = layout
        assert tile == tns.LSE_TILE and tiles * tile >= D > (tiles - 1) * tile
        assert groups * tns.LSE_GROUP >= B > (groups - 1) * tns.LSE_GROUP
        assert grid == (groups, tiles)


@pytest.mark.parametrize("widths", LSE_WIDTHS)
def test_lse_plan_instance_by_widths(widths):
    for B in MS:
        for D in DS:
            assert tns.lse_plan(B, D, *widths).instance == (
                "fixed" if widths == (2, 1) else "general")


@pytest.mark.parametrize("bad", [(0, 1), (15, 1), (16, 0), (2, -1)])
def test_lse_plan_refuses_bad_widths(bad):
    """R = 0 and C < 0 stay refused; (15, 1) and (16, 0) (17 stacked
    rows, which the port once refused) take the general instance, which
    walks its rows in slices: K1 has no width limit."""
    R, C = bad
    if R >= 1 and C >= 0:
        assert tns.lse_plan(10, 100, *bad).instance == "general"
    else:
        with pytest.raises(ValueError, match="stacked rows"):
            tns.lse_plan(10, 100, *bad)
    with pytest.raises(ValueError, match="empty"):
        tns.lse_plan(0, 100, 2, 1)
    with pytest.raises(ValueError, match="empty"):
        tns.lse_plan(10, 0, 2, 1)


# ----------------------------------------------------------------------
# the kernel routes refuse before any CUDA call
# ----------------------------------------------------------------------

def _bwd_operands(M=5, D=70, r1=2, r2=2, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.poisson(1.0, (M, D)).astype(np.int8))
    g1 = torch.from_numpy(rng.normal(size=(M, r1)).astype(np.float32))
    g2 = (torch.from_numpy(rng.normal(size=(M, r2)).astype(np.float32))
          if r2 else None)
    return x, g1, g2


@pytest.mark.parametrize("widths", [(2, 2), (5, 3), (12, 3), (16, 0),
                                    (7, 9), (18, 2)])
def test_bwd_kernel_route_refuses_cpu_tensors_at_every_instance(widths):
    """A CPU tensor at K5's kernel route raises whatever the plan's
    instance; the public wrapper takes the plain version instead."""
    x, g1, g2 = _bwd_operands(r1=widths[0], r2=widths[1])
    with pytest.raises(ValueError, match="no kernel"):
        tek._bwd_kernel_route(x, g1, g2)
    before = tek.count_encode_bwd.launches
    dWL, dWX = tek.count_encode_bwd(x, g1, g2)
    assert tek.count_encode_bwd.launches == before
    assert dWL.shape == (widths[0], 70)
    assert (dWX is None) == (widths[1] == 0)


@pytest.mark.parametrize("bad", ["empty_rows", "empty_cols", "no_slots",
                                 "rank", "rows", "dtype", "g_dtype"])
def test_bwd_kernel_route_refuses_bad_operands(bad):
    x, g1, g2 = _bwd_operands()
    err, match = ValueError, {
        "empty_rows": "empty", "empty_cols": "empty", "no_slots": "empty",
        "rank": "2-D", "rows": "rows", "dtype": "int8",
        "g_dtype": "float32"}[bad]
    if bad == "empty_rows":
        x, g1, g2 = x[:0], g1[:0], g2[:0]
    elif bad == "empty_cols":
        x = x[:, :0]
    elif bad == "no_slots":
        g1, g2 = g1[:, :0], None
    elif bad == "rank":
        g1 = g1[:, 0]
    elif bad == "rows":
        g2 = g2[:3]
    elif bad == "dtype":
        err, x = TypeError, x.to(torch.int32)
    else:
        err, g1 = TypeError, g1.double()
    with pytest.raises(err, match=match):
        tek._bwd_kernel_route(x, g1, g2)


@pytest.mark.parametrize("widths", LSE_WIDTHS)
def test_lse_kernel_route_refuses_cpu_tensors_at_every_instance(widths):
    R, C = widths
    rng = np.random.default_rng(3)
    zc = torch.from_numpy(rng.normal(size=(5, R + C)).astype(np.float32))
    W = torch.from_numpy(rng.normal(size=(R + C + 1, 70)).astype(np.float32))
    with pytest.raises(ValueError, match="no kernel"):
        tns._lse_kernel(zc, W, R, C)
    before = tns.lse.launches
    assert tns.lse(zc, W, R, C).shape == (5, 1)
    assert tns.lse.launches == before


@pytest.mark.parametrize("bad", ["widths", "empty_rows", "empty_cols",
                                 "short_W", "zc_width"])
def test_lse_kernel_route_refuses_bad_operands(bad):
    rng = np.random.default_rng(4)
    R, C = 2, 1
    zc = torch.from_numpy(rng.normal(size=(5, 3)).astype(np.float32))
    W = torch.from_numpy(rng.normal(size=(4, 70)).astype(np.float32))
    match = {"widths": "stacked rows", "empty_rows": "empty",
             "empty_cols": "empty", "short_W": "R \\+ C \\+ 1 rows",
             "zc_width": "do not match"}[bad]
    if bad == "widths":  # R = 0: no latents (any R >= 1 is taken)
        R, C = 0, 3
    elif bad == "empty_rows":
        zc = zc[:0]
    elif bad == "empty_cols":
        W = W[:, :0]
    elif bad == "short_W":
        W = W[:3]
    else:
        zc = zc[:, :2]
    with pytest.raises(ValueError, match=match):
        tns._lse_kernel(zc, W, R, C)


# ----------------------------------------------------------------------
# every K5 and K1 call of the trainer CLIs, spied on the CPU
# ----------------------------------------------------------------------

def _cli_calls(monkeypatch, tmp_path):
    """{run: (K5 calls (M, D, r1, r2), K1 calls (B, D, R, C), batches)}
    of the trainer CLIs at their defaults (NB, joint, labeled mixture)
    and of NB with a hidden encoder, one epoch each on the CPU."""
    from mmvae_tpu.io.writers import write_matrix_market_file
    from mmvae_tpu_torch.cli import nb_vae, vmfnb_vae

    k5, k1 = [], []
    bwd_ref, lse_ref = tek.count_encode_bwd_ref, tns.lse_ref

    def spy_bwd(x, g1, g2):
        k5.append((*x.shape, g1.shape[1], 0 if g2 is None else g2.shape[1]))
        return bwd_ref(x, g1, g2)

    def spy_lse(zc, W, R, C):
        k1.append((zc.shape[0], W.shape[1], R, C))
        return lse_ref(zc, W, R, C)

    monkeypatch.setattr(tek, "count_encode_bwd_ref", spy_bwd)
    monkeypatch.setattr(tns, "lse_ref", spy_lse)
    D, N, B = 30, 40, 20
    rng = np.random.default_rng(9)
    dens = rng.poisson(1.5, size=(D, N)).astype(np.float32)
    dens[0, ~(dens > 0).any(axis=0)] = 1.0
    rr, cc = np.nonzero(dens)
    mtx = str(tmp_path / "m.mtx.gz")
    write_matrix_market_file(mtx, rr, cc, dens[rr, cc], (D, N))
    (tmp_path / "rows.txt").write_text("".join(f"g{i}\n" for i in range(D)))
    (tmp_path / "annot.txt").write_text(
        "".join(f"g{i} T{i % 10}\n" for i in range(20)))  # K = 10
    common = ["--mtx", mtx, "--batch_size", str(B), "--max_epoch", "1",
              "--device", "cpu"]
    runs = {"nb": (nb_vae, []), "nb --mean_encoding 4": (
        nb_vae, ["--mean_encoding", "4"]), "joint": (vmfnb_vae, []),
        "mixture": (vmfnb_vae, ["--annot", str(tmp_path / "annot.txt"),
                                "--row", str(tmp_path / "rows.txt")])}
    out = {}
    for i, (name, (cli, extra)) in enumerate(runs.items()):
        n5, n1 = len(k5), len(k1)
        assert cli.main(common + extra + ["--out",
                                          str(tmp_path / f"o{i}")]) == 0
        out[name] = (k5[n5:], k1[n1:], N // B)
    return out


def test_cli_calls_take_the_compile_time_instances(monkeypatch, tmp_path):
    """At the trainers' defaults every K5 call takes its compile-time
    instance ((2, 2) NB, (5, 3) joint, (12, 3) the mixture with K = 10
    labels, the README's row) and every K1 call
    the (2, 1) one, 3 K5 and 4 K1 a batch; NB with a hidden encoder keeps
    K1 on it, while its K5 contracts the hidden width (4 + 2) and takes
    the general instance."""
    calls = _cli_calls(monkeypatch, tmp_path)
    want = {"nb": (2, 2), "joint": (5, 3), "mixture": (12, 3),
            "nb --mean_encoding 4": (4, 2)}
    for name, (k5, k1, batches) in calls.items():
        assert {c[2:] for c in k5} == {want[name]}, name
        assert {c[2:] for c in k1} == {(2, 1)}, name
        assert len(k5) == 3 * batches and len(k1) == 4 * batches, name
        for M, D, r1, r2 in k5:
            (plan,) = [tek.bwd_plan(M, D, l1 - l0, x1 - x0)
                       for l0, l1, x0, x1 in tek.bwd_groups(r1, r2)]
            assert plan.instance == (
                "general" if name == "nb --mean_encoding 4" else "fixed")
        for B, D, R, C in k1:
            assert tns.lse_plan(B, D, R, C).instance == "fixed"


# ----------------------------------------------------------------------
# chip_smoke.py phase 1 reads every count_encode_bwd.cu and nb_lse.cu
# instance's registers and spills from ptxas' report
# ----------------------------------------------------------------------

_ENTRY = ("ptxas info    : Compiling entry function '_ZN48_GLOBAL__N__"
          "11bf2b74_{n}_{src}_4cdaf3a9{name}' for 'sm_90a'\n"
          "ptxas info    : Function properties for _ZN{name}\n"
          "    0 bytes stack frame, {spill} bytes spill stores, {spill} "
          "bytes spill loads\n"
          "ptxas info    : Used {regs} registers, used 1 barriers\n")


def _log(spill=0):
    bwd = "".join(_ENTRY.format(n=19, src="count_encode_bwd_cu", name=n,
                                spill=b, regs=r) for n, b, r in (
        ("22count_encode_bwd_tilesIaLi2ELi2EEEvPKT_llPKfilS5_ilS3_PfS6_S6_",
         0, 40),
        ("22count_encode_bwd_tilesIsLi12ELi3EEEvPKT_llPKfilS5_ilS3_PfS6_S6_",
         0, 80),
        ("22count_encode_bwd_tilesIfLi0ELi0EEEvPKT_llPKfilS5_ilS3_PfS6_S6_",
         spill, 85),
        ("20count_encode_bwd_sumEPKfliilPfS2_", 0, 16)))
    lse = "".join(_ENTRY.format(n=9, src="nb_lse_cu", name=n, spill=b,
                                regs=r) for n, b, r in (
        ("9lse_tilesILi3EEEvPKfS2_lliPf", 0, 56),
        ("9lse_tilesILi0EEEvPKfS2_lliPf", spill, 72),
        ("7lse_sumEPKfllPf", 0, 20)))
    other = _ENTRY.format(n=15, src="count_encode_cu", spill=16, regs=128,
                          name="18count_encode_tilesIaLi16ELi4ELb0ELb0EEEv")
    return (f"== count_encode.cu\n{other}== count_encode_bwd.cu\n{bwd}"
            f"== nb_lse.cu\n{lse}")


def test_bwd_lse_instances_read_by_phase_1():
    import chip_smoke

    assert chip_smoke.check_instances(
        _log(), "count_encode_bwd.cu", chip_smoke.bwd_label) == [
        ("int8 2+2", 40, 0), ("int16 12+3", 80, 0), ("f32 general", 85, 0),
        ("sum", 16, 0)]
    assert chip_smoke.check_instances(
        _log(), "nb_lse.cu", chip_smoke.lse_label) == [
        ("R+C=3", 56, 0), ("general", 72, 0), ("sum", 20, 0)]


@pytest.mark.parametrize("source,label", [
    ("count_encode_bwd.cu", "bwd_label"), ("nb_lse.cu", "lse_label")])
def test_bwd_lse_instances_spill_fails_phase_1(source, label):
    import chip_smoke

    with pytest.raises(AssertionError, match=f"{source} instances spill"):
        chip_smoke.check_instances(_log(spill=8), source,
                                   getattr(chip_smoke, label))
    with pytest.raises(AssertionError, match="no instance"):
        chip_smoke.check_instances("== nb_value.cu\n", source,
                                   getattr(chip_smoke, label))
