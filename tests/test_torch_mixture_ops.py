"""The labeled mixture's ops in the port against the JAX package's: the
annotation matrix, ``uniform_kl``, and the count encoder's filtered row
stats (``count_encode(..., want_stats=True, filt=)``, K4f's plain
version) with its weight VJP — against the XLA specification
``_xla_encode`` and the Pallas kernel in interpret mode.

On the CPU the wrapper runs its plain version; ``chip_smoke.py`` holds
the CUDA kernel against the same plain version on the card.

Tolerances and why:

- the annotation matrix: exact (0/1 entries, label order);
- ``uniform_kl``: ``rtol=1e-6`` (the same float32 formula, summed by two
  libraries);
- count encoder: ``|port - jax| <= 1e-5 * S + 1e-6``, S the sum of the
  terms' magnitudes (float32 reassociation over D); the stats against
  themselves (every term of ``L``, ``L^2``, ``L f`` and ``L^2 f`` is
  non-negative for a non-negative filter).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mmvae_tpu.ops.enc_kernel as jek
from mmvae_tpu.data.annotation import Annotation as JAnnotation
from mmvae_tpu.ops.losses import uniform_kl as juniform_kl
from mmvae_tpu_torch.data.annotation import Annotation
from mmvae_tpu_torch.ops import enc_kernel as tek
from mmvae_tpu_torch.ops.losses import uniform_kl

DTYPES = {"int8": np.int8, "int16": np.int16, "float32": np.float32}


# ----------------------------------------------------------------------
# annotation and uniform KL
# ----------------------------------------------------------------------

def test_annotation_matches_jax(tmp_path):
    """Labels numbered by first appearance among listed features, pairs
    of unlisted features and unknown labels skipped, a feature in two
    labels, duplicate pairs, blank lines."""
    rows = [f"g{i}" for i in range(9)]
    (tmp_path / "rows.txt").write_text("\n".join(rows) + "\n\n")
    pairs = ["gX T", "g3 B", "g1 A", "g3 A", "g7 C", "g3 B", "", "g0 B",
             "zz Q", "g8 C extra"]
    (tmp_path / "annot.txt").write_text("\n".join(pairs) + "\n")
    args = (str(tmp_path / "annot.txt"), str(tmp_path / "rows.txt"))
    got, want = Annotation(*args), JAnnotation(*args)
    assert got.labels == want.labels == ["B", "A", "C"]
    assert (got.D, got.K) == (want.D, want.K) == (9, 3)
    np.testing.assert_array_equal(got.matrix(), want.matrix())
    assert got.matrix().dtype == np.float32


def test_annotation_without_listed_features(tmp_path):
    (tmp_path / "rows.txt").write_text("a\nb\n")
    (tmp_path / "annot.txt").write_text("c X\n")
    args = (str(tmp_path / "annot.txt"), str(tmp_path / "rows.txt"))
    np.testing.assert_array_equal(Annotation(*args).matrix(),
                                  JAnnotation(*args).matrix())
    assert Annotation(*args).matrix().shape == (2, 1)


@pytest.mark.parametrize("K", [1, 5, 10, 33])
def test_uniform_kl_matches_jax(K):
    """``fasterlog(K)``, not ``log(K)``, as the reference has it."""
    rng = np.random.default_rng(K)
    logits = rng.normal(size=(7, K)).astype(np.float32) * 3
    lnq = np.array(jax.nn.log_softmax(jnp.asarray(logits), axis=1))
    want = float(juniform_kl(jnp.asarray(lnq)))
    got = float(uniform_kl(torch.from_numpy(lnq)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# ----------------------------------------------------------------------
# count encoder with filtered stats (K4f's plain version)
# ----------------------------------------------------------------------

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
    # a marker-gene mask: about a quarter of the features covered
    filt = (rng.random((1, D)) < 0.25).astype(np.float32)
    return x, WL, WX, filt


def _assert_scaled(got, want, S):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    lim = 1e-5 * S + 1e-6
    err = np.abs(got - want)
    assert np.all(err <= lim), f"max err/limit {np.max(err / lim):.3g}"


def _check(got, want, x, WL, WX):
    xf = x.astype(np.float64)
    _assert_scaled(got[0], want[0], np.abs(np.log1p(xf)) @ np.abs(WL.T))
    if WX.shape[0]:
        _assert_scaled(got[1], want[1], np.abs(xf) @ np.abs(WX.T))
    st = np.asarray(want[2], np.float64)
    _assert_scaled(got[2], st, np.abs(st))


@pytest.mark.parametrize("dtype", list(DTYPES))
# D = 255, 256, 257: either side of the forward kernel's 256-column tile
@pytest.mark.parametrize("D,r1,r2", [(640, 7, 3), (1003, 7, 3),
                                     (1003, 6, 1), (255, 7, 3), (256, 6, 1),
                                     (257, 7, 3)])
@pytest.mark.parametrize("interpret", [False, True])
def test_count_encode_filt_matches_jax(monkeypatch, dtype, D, r1, r2,
                                       interpret):
    """At the mixture step's widths (r1 = R + K = 7 log1p rows, r2 =
    H + 2 = 3 raw rows) and the serving call's (r1 = R + K, r2 = 1), a
    ragged D, against ``_xla_encode`` and interpret-mode K4."""
    monkeypatch.setattr(jek, "_INTERPRET", interpret)
    x, WL, WX, filt = _inputs(8, D, r1, r2, dtype, seed=D + r1 + r2)
    want = jek.count_encode(jnp.asarray(x), jnp.asarray(WL), jnp.asarray(WX),
                            jnp.asarray(filt), True)
    got = tek.count_encode(torch.from_numpy(x), torch.from_numpy(WL),
                           torch.from_numpy(WX), want_stats=True,
                           filt=torch.from_numpy(filt))
    assert len(got) == 3 and got[2].shape == (8, 4)
    _check([t.numpy() for t in got], [np.asarray(w) for w in want], x, WL,
           WX)
    # the filtered pair differs from the plain one, which stays unchanged
    st = got[2].numpy()
    assert not np.allclose(st[:, 2:], st[:, :2])
    plain = tek.count_encode(torch.from_numpy(x), torch.from_numpy(WL),
                             torch.from_numpy(WX), want_stats=True)[2]
    assert torch.equal(got[2][:, :2], plain[:, :2])


@pytest.mark.parametrize("shape", ["row", "flat"])
def test_count_encode_ref_filt_shapes_and_weights(shape):
    """A (1, D) or (D,) filter; the sums are ``sum L f`` and
    ``sum (L f) L`` for any float filter (as ``_xla_encode``), which the
    float64 sums bound."""
    x, WL, WX, _ = _inputs(5, 300, 2, 1, "int16", seed=3)
    f = np.random.default_rng(1).random((1, 300)).astype(np.float32)
    ft = torch.from_numpy(f if shape == "row" else f[0])
    st = tek.count_encode_ref(torch.from_numpy(x), torch.from_numpy(WL),
                              torch.from_numpy(WX), True, ft)[2].numpy()
    L = np.log1p(x.astype(np.float64))
    want = np.stack([L.sum(1), (L * L).sum(1), (L * f).sum(1),
                     (L * f * L).sum(1)], axis=1)
    _assert_scaled(st, want, want)


def test_count_encode_filt_vjp_matches_jax():
    """The filter changes no gradient: the weight VJP with the filtered
    stats equals JAX's and the one without stats."""
    x, WL, WX, filt = _inputs(9, 640, 7, 3, "int8", seed=5)
    rng = np.random.default_rng(7)
    g1 = rng.normal(size=(9, 7)).astype(np.float32)
    g2 = rng.normal(size=(9, 3)).astype(np.float32)
    _, vjp = jax.vjp(lambda wl, wx: jek.count_encode(
        jnp.asarray(x), wl, wx, jnp.asarray(filt), True)[:2],
        jnp.asarray(WL), jnp.asarray(WX))
    eL, eX = vjp((jnp.asarray(g1), jnp.asarray(g2)))
    grads = []
    for f in (torch.from_numpy(filt), None):
        wl = torch.from_numpy(WL).requires_grad_()
        wx = torch.from_numpy(WX).requires_grad_()
        out = tek.count_encode(torch.from_numpy(x), wl, wx,
                               want_stats=f is not None, filt=f)
        assert f is None or not out[2].requires_grad
        torch.autograd.backward(list(out[:2]), [torch.from_numpy(g1),
                                                torch.from_numpy(g2)])
        grads.append((wl.grad, wx.grad))
    xf = x.astype(np.float64)
    _assert_scaled(grads[0][0].numpy(), eL,
                   np.abs(g1.T).astype(np.float64) @ np.log1p(xf))
    _assert_scaled(grads[0][1].numpy(), eX,
                   np.abs(g2.T).astype(np.float64) @ np.abs(xf))
    assert torch.equal(grads[0][0], grads[1][0])
    assert torch.equal(grads[0][1], grads[1][1])


def test_count_encode_filt_cpu_launches_nothing_and_checks():
    """On the CPU no counter moves; the kernel route refuses a CPU tensor
    and a filter of the wrong width; a filter needs ``want_stats``."""
    x, WL, WX, filt = (torch.from_numpy(a)
                       for a in _inputs(4, 64, 2, 1, "int8"))
    counters = ("launches", "stats_launches", "filt_launches")
    before = [getattr(tek.count_encode, c) for c in counters]
    tek.count_encode(x, WL, WX, want_stats=True, filt=filt)
    assert [getattr(tek.count_encode, c) for c in counters] == before
    with pytest.raises(ValueError, match="no kernel"):
        tek._kernel_route(x, WL, WX, True, filt)
    with pytest.raises(ValueError, match="filt must have"):
        tek._check_kernel_args(x, WL, WX, filt[:, :32])
    with pytest.raises(TypeError, match="filt must be float32"):
        tek._check_kernel_args(x, WL, WX, filt.double())
    for fn in (tek.count_encode, tek.count_encode_ref):
        with pytest.raises(ValueError, match="want_stats"):
            fn(x, WL, WX, False, filt)
