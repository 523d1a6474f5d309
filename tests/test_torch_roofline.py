"""The roofline probe P1 of the port (``mmvae_tpu_torch.benchmarks.
valgrad_roofline``) against the JAX probe's Pallas kernel
(``benchmarks/valgrad_roofline.py:_elementwise_kernel``) in interpret
mode, and the probe's arithmetic.

The JAX script is loaded as a fresh module from its file, its tile
globals shrunk to (8, 128) x 3 and its ``pl`` swapped for a namespace
whose ``pallas_call`` runs in interpret mode; the file itself is
unchanged.  Tolerance: ``rtol=1e-5`` — both are float32, XLA's and
torch's exp / log1p differ by an ulp or two, and every op class is a
contraction, so the differences stay a few ulp after 8 repetitions.

The plain version runs on one torch thread here: torch splits an
elementwise exp / log1p of more than 2,048 elements over its OpenMP
workers, and in a process that has run XLA a worker can compute them
differently from the main thread (seen: now and then, the second half of
the rows of ``exp`` off by ~3e-5 relative, the first half exact).
"""

import functools
import importlib.util
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from mmvae_tpu_torch.benchmarks import valgrad_roofline as vr
from mmvae_tpu_torch.ops import nb_step as ns

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the JAX probe's op classes, as its main() defines them (:169-175)
JAX_OPS = {
    "fma": lambda y: y * 0.9999 + 1e-4,
    "exp": lambda y: jnp.exp(-y) * 0.5 + 0.25,
    "log": lambda y: jnp.log1p(y) * 0.8 + 0.1,
    "div": lambda y: 1.0 / (1.0 + y),
    "select": lambda y: jnp.where(y > 0.5, y * 0.9, y),
}


@pytest.fixture(scope="module")
def jprobe():
    spec = importlib.util.spec_from_file_location(
        "_jax_valgrad_roofline",
        os.path.join(ROOT, "benchmarks", "valgrad_roofline.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.BP, mod.TD, mod.NJ = 8, 128, 3
    mod.D = mod.TD * mod.NJ
    mod.pl = types.SimpleNamespace(
        pallas_call=functools.partial(pl.pallas_call, interpret=True),
        BlockSpec=pl.BlockSpec)
    return mod


@pytest.mark.parametrize("nrep", [2, 8])
@pytest.mark.parametrize("chains", [1, 4])
@pytest.mark.parametrize("op", list(JAX_OPS))
def test_plain_matches_pallas_interpret(jprobe, op, chains, nrep):
    x = np.random.default_rng(0).uniform(0.1, 0.9, (jprobe.BP, jprobe.D))
    x = x.astype(np.float32)
    want = np.asarray(jprobe._elementwise_kernel(nrep, JAX_OPS[op], chains)(
        jnp.asarray(x)))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        got = vr.elementwise_ref(torch.from_numpy(x), op, nrep,
                                 chains).numpy()
    finally:
        torch.set_num_threads(threads)
    assert got.dtype == np.float32 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_wrapper_takes_plain_version_on_cpu():
    x = vr.probe_input("cpu", (5, 70))
    before = vr.elementwise.launches
    for op in vr.OPS:
        got = vr.elementwise(x, op, 8, 4)
        assert torch.equal(got, vr.elementwise_ref(x, op, 8, 4))
    assert vr.elementwise.launches == before
    with pytest.raises(ValueError, match="op must be one of"):
        vr.elementwise(x, "sqrt", 8)


def test_main_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a host without a GPU")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        vr.main()


def test_op_mix_prediction_keeps_the_jax_arithmetic():
    """exp / log / div carry one FMA each, which is subtracted; the ALU
    rate is the better of fma and select / 2."""
    rates = {"fma": 2.0, "exp": 7.0, "log": 1.0, "div": 5.0, "select": 3.0}
    total, parts = vr.op_mix_prediction(rates, 10)
    assert parts == {"ALU": vr.ALU_OPS * 1.5 * 10, "exp": vr.EXP_OPS * 5.0
                     * 10, "log": 0.0, "div": vr.DIV_OPS * 3.0 * 10}
    assert total == pytest.approx(sum(parts.values()))
    assert (vr.ALU_OPS, vr.EXP_OPS, vr.LOG_OPS, vr.DIV_OPS) == (116, 2, 2, 2)


@pytest.mark.parametrize("kernel", list(vr.OP_MIX))
def test_op_mix_prediction_of_each_instance(kernel):
    """Every K2, K6, K3, K7 and K8 instance prices its own op mix."""
    rates = {"fma": 2.0, "exp": 7.0, "log": 4.0, "div": 5.0, "select": 3.0}
    alu, n_exp, n_log, n_div = vr.OP_MIX[kernel]
    total, parts = vr.op_mix_prediction(rates, 10, kernel)
    assert parts == {"ALU": alu * 1.5 * 10, "exp": n_exp * 5.0 * 10,
                     "log": n_log * 2.0 * 10, "div": n_div * 3.0 * 10}
    assert total == pytest.approx(sum(parts.values()))


def test_op_mix_of_the_variants():
    """The value-bearing instances add the lgamma terms (26 ALU, 2 log)
    to their grad-only twins; the JOINT ones drop the softplus and the
    sigmoid (fewer ALU operations, one log)."""
    mix = vr.OP_MIX
    for grad, value in (("nb_valgrad", "nb_valgrad[value]"),
                        ("nb_valgrad[pb,nu_exp]",
                         "nb_valgrad[pb,nu_exp,value]")):
        assert [v - g for g, v in zip(mix[grad], mix[value])] == [26, 0, 2, 0]
    assert mix["nb_valgrad[pb,nu_exp]"][0] < mix["nb_valgrad"][0]
    assert mix["nb_valgrad[pb,nu_exp]"][2] == 1


def test_op_mix_of_k6_and_k3():
    """K6 and K6p price their compile-time instances as K2's are priced:
    the joint one drops the softplus (log1p) and the clip for the pb
    multiply and exp-nu's min; K3 is an FMA chain with one exp, no log
    and no divide; each is below K2's ALU count."""
    mix = vr.OP_MIX
    assert mix["nb_value"] == (79, 2, 5, 1)
    assert mix["nb_value[pb,nu_exp]"] == (76, 2, 4, 1)
    assert mix["nb_finish"] == (25, 1, 0, 0)
    for k in ("nb_value", "nb_value[pb,nu_exp]", "nb_finish"):
        assert mix[k][0] < mix["nb_valgrad"][0]


def test_op_mix_of_k7_and_k8():
    """K7, K7c and K8 (csrc/nb_elbo.cu) price their integer-count
    instances as K2's are priced: K7c adds the select-products of
    lgamma(x + 1) (18 ALU) and the divide of Pc / P to K7; K7 spends one
    exp more than K6 (the row's sum of exp) and no logits; K8's
    digamma select-products (42) and shared divide (9) are K2's."""
    mix = vr.OP_MIX
    assert mix["nb_elbo_fwd"] == (72, 3, 4, 1)
    assert mix["nb_elbo_fwd[const]"] == (90, 3, 4, 2)
    assert mix["nb_elbo_bwd"] == (92, 2, 2, 2)
    assert [c - n for n, c in zip(mix["nb_elbo_fwd"],
                                  mix["nb_elbo_fwd[const]"])] == [18, 0, 0, 1]
    assert mix["nb_elbo_fwd"][1] == mix["nb_value"][1] + 1
    assert mix["nb_elbo_bwd"][2:] == mix["nb_valgrad"][2:]


def test_block_regimes():
    x = np.zeros((4, 130), np.int8)
    x[2, 70] = 9  # the second of three blocks leaves the <= 7 regime
    r = vr.block_regimes(x)
    assert r["blocks"] == 3
    assert r["counts <= 7"] == pytest.approx(2 / 3)
    assert r["integer"] == pytest.approx(1 / 3) and r["general"] == 0.0


def test_valgrad_inputs_joint_run_the_plain_k2p():
    """The JOINT instances' isolated inputs append the pb row."""
    t, _ = vr.valgrad_inputs("cpu", joint=True)
    assert t["W"].shape == (7, vr.D)
    lse = ns.lse(t["zc"], t["W"], t["R"], t["C"])
    gout, rsum, u1, dzn, nll = ns.valgrad(
        t["x"], t["zc"], t["zn"], t["depth"], lse, t["W"], t["R"], t["C"],
        t["Rn"], True, True)
    assert gout.shape == (7, vr.D) and torch.isfinite(nll)
    assert torch.equal(gout[-1], gout[3])  # d/d pb = colsum(dls)


def test_valgrad_inputs_run_the_plain_k2():
    """The isolated K2's inputs have the main path's shapes and run
    through ``nb_step.valgrad`` (its plain version on the CPU)."""
    t, x = vr.valgrad_inputs("cpu")
    assert x.shape == (vr.B, vr.D) and x.dtype == np.int8
    assert t["W"].shape == (6, vr.D) and t["zc"].shape == (vr.B, 3)
    lse = ns.lse(t["zc"], t["W"], t["R"], t["C"])
    gout, rsum, u1, dzn = ns.valgrad(t["x"], t["zc"], t["zn"], t["depth"],
                                     lse, t["W"], t["R"], t["C"], t["Rn"])
    assert gout.shape == (6, vr.D) and rsum.shape == (vr.B, 1)
    assert u1.shape == (vr.B, 2) and dzn.shape == (vr.B, 1)
    assert all(torch.isfinite(a).all() for a in (gout, rsum, u1, dzn))
    # Poisson(1.0): a few of the 313 blocks see a count above 7
    reg = vr.block_regimes(x)
    assert reg["blocks"] == 313 and 0.8 < reg["counts <= 7"] < 1.0
