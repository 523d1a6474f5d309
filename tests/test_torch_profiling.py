"""The port's tooling against the JAX package's: ``utils.summary.
pretty_print`` (the same text for the same model and parameters),
``utils.profiling`` (``trace`` under ``MMVAE_TRACE_DIR``, ``annotate``,
``StepTimer``, the kernel-time reader) and
``benchmarks.trace_step`` (build and summary on the CPU).
"""

import io
import json
import os
import pkgutil
import time

import jax
import numpy as np
import pytest
import torch

import mmvae_tpu_torch
from mmvae_tpu.models.nb import NBVAE as JNBVAE
from mmvae_tpu.models.vmfnb import VMFNBVAE as JVMFNBVAE
from mmvae_tpu.models.vmfnb_mixture import VMFNBMixtureVAE as JMixture
from mmvae_tpu.utils import profiling as jprof
from mmvae_tpu.utils.summary import pretty_print as jpretty_print
from mmvae_tpu_torch.benchmarks import trace_step
from mmvae_tpu_torch.models.nb import NBVAE, params_from_numpy
from mmvae_tpu_torch.models.vmfnb import VMFNBVAE
from mmvae_tpu_torch.models.vmfnb_mixture import VMFNBMixtureVAE
from mmvae_tpu_torch.utils import profiling
from mmvae_tpu_torch.utils.summary import pretty_print

D = 40


def _label():
    rng = np.random.default_rng(0)
    label = rng.random((D, 4)) < 0.3
    label[:, 0] |= ~label.any(axis=1)
    return label


MODELS = {
    "nb": lambda: (JNBVAE(data_dim=D, covar_dim=1), NBVAE(data_dim=D)),
    "nb_hidden": lambda: (
        JNBVAE(data_dim=D, covar_dim=2, mean_encoding=(16,),
               mean_decoding=(8,), do_relu=True),
        NBVAE(data_dim=D, covar_dim=2, mean_encoding=(16,),
              mean_decoding=(8,), do_relu=True)),
    "joint": lambda: (JVMFNBVAE(data_dim=D, vmf_decoding=(8,)),
                      VMFNBVAE(data_dim=D, vmf_decoding=(8,))),
    "mixture": lambda: (JMixture(label=_label()),
                        VMFNBMixtureVAE(label=_label())),
}


@pytest.mark.parametrize("kind", list(MODELS))
def test_pretty_print_matches_jax(kind):
    jmodel, model = MODELS[kind]()
    jparams = jax.tree_util.tree_map(np.asarray,
                                     jmodel.init(jax.random.PRNGKey(0)))
    want, got = io.StringIO(), io.StringIO()
    jpretty_print(jmodel, jparams, file=want)
    pretty_print(model, params_from_numpy(jparams), file=got)
    assert got.getvalue() == want.getvalue()
    assert got.getvalue().startswith(type(model).__name__ + "(")


def test_trace_env_writes_annotated_trace(tmp_path, monkeypatch):
    monkeypatch.setenv("MMVAE_TRACE_DIR", str(tmp_path / "tr"))
    with profiling.trace() as prof:
        with profiling.annotate("port_region"):
            a = torch.ones(64, 64)
            (a @ a).sum()
    assert prof is not None
    files = os.listdir(tmp_path / "tr")
    assert len(files) == 1 and files[0].endswith(".trace.json")
    with open(tmp_path / "tr" / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "port_region" for e in events)
    # a CPU profile has no device events, and host time by op
    assert profiling.kernel_times(prof) == {}
    host = profiling.host_times(prof)
    assert "aten::mm" in host and host["aten::mm"][1] == 1


def test_trace_without_dir_is_a_no_op(tmp_path, monkeypatch):
    monkeypatch.delenv("MMVAE_TRACE_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    with profiling.trace() as prof:
        torch.ones(3).sum()
    assert prof is None and os.listdir(tmp_path) == []


def test_step_timer_sums_as_jax(monkeypatch):
    """The same phases under one scripted clock give the same totals in
    both packages' timers, and after a reset only the new phases."""
    results = []
    for mod in (jprof, profiling):
        clock = iter(np.arange(0.0, 100.0, 0.25))
        monkeypatch.setattr(time, "perf_counter", lambda: float(next(clock)))
        timer = mod.StepTimer()
        for name in ("step", "record_submit", "step", "input"):
            with timer.phase(name):
                pass
        first = timer.summary()
        timer.reset()
        with timer.phase("step"):
            pass
        results.append((first, timer.summary()))
    assert results[0] == results[1]
    assert results[1] == ({"step": 0.5, "record_submit": 0.25,
                           "input": 0.25}, {"step": 0.25})


@pytest.mark.parametrize("kind", ["nb", "vmf", "joint", "mixture"])
def test_trace_step_runs_on_cpu(kind, tmp_path, capsys):
    rows = trace_step.main([kind, "64", "2", "8", "--device", "cpu",
                            "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert "host op self time (CPU run: not device time)" in out
    assert "device kernel" not in out
    assert rows and all(us >= 0 and n >= 1 for us, n in rows.values())
    assert any(f.endswith(".trace.json") for f in os.listdir(tmp_path))


def test_trace_step_build_matches_jax_models():
    """The models ``build`` makes are the JAX script's: default
    architecture, the mixture's K = 5 label from numpy seed 0."""
    model, fast, params = trace_step.build("mixture", 64, 2, "cpu")
    rng = np.random.default_rng(0)
    label = rng.random((64, 5)) < 0.3
    label[:, 0] |= ~label.any(axis=1)
    np.testing.assert_array_equal(model.label, label.astype(np.float32))
    assert type(fast).__name__ == "VMFNBMixtureFastStep"
    model, fast, _ = trace_step.build("nb", 64, 2, "cpu")
    assert (model.data_dim, model.covar_dim, model.mean_latent) == (64, 1, 2)
    assert type(fast).__name__ == "NBFastStep"


def test_trace_step_vmf_not_ported():
    """Once refused, the ``vmf`` kind now builds the JAX script's model:
    the default vMF-VAE (covariate 1, latent 2) on its packed step."""
    model, fast, params = trace_step.build("vmf", 64, 2, "cpu")
    assert (model.data_dim, model.covar_dim, model.latent) == (64, 1, 2)
    assert not model.encoding and not model.decoding
    assert type(fast).__name__ == "VMFFastStep"
    assert tuple(params["encoding"]["weight"].shape) == (64, 2)


def test_port_kernel_names():
    assert trace_step.port_kernel(
        "void (anonymous namespace)::valgrad_tiles<signed char, 2, 1, 1, "
        "false, false>(signed char const*)") == "nb_valgrad"
    assert trace_step.port_kernel(
        "(anonymous namespace)::elbo_fwd_sum(float const*, long, float*)"
    ) == "nb_elbo_fwd"
    assert trace_step.port_kernel(
        "void (anonymous namespace)::lse_sum(float const*)") == "nb_lse"
    for torch_kernel in ("void at::native::vectorized_elementwise_kernel<4>",
                         "void at::native::elementwise_kernel<128, 2>(int)"):
        assert trace_step.port_kernel(torch_kernel) == "torch"
    assert trace_step.port_kernel(
        "void (anonymous namespace)::elementwise_kernel<0, 40, 4>(float "
        "const*)") == "roofline_probe"


def test_port_kernel_names_valgrad_stages():
    """Both stages of K2 (``csrc/nb_valgrad.cu``) are K2's time in the
    table, in every instance; so are both stages of K7 (``csrc/nb_elbo.cu``,
    whose second stage was ``reduce_parts``) K7's."""
    for stage in ("void (anonymous namespace)::valgrad_tiles<short, 0, 0, "
                  "0, true, true>(short const*, float const*)",
                  "void (anonymous namespace)::valgrad_tiles<float, 2, 1, 1, "
                  "true, false>(float const*, float const*)",
                  "(anonymous namespace)::valgrad_sum(float const*, float "
                  "const*, float const*, long, long, int, long, int, int, "
                  "int, long, long, long, float*, float*, float*)"):
        assert trace_step.port_kernel(stage) == "nb_valgrad"
    for stage in ("void (anonymous namespace)::elbo_fwd_rows<signed char, "
                  "true, true>(signed char const*, float const*)",
                  "(anonymous namespace)::elbo_fwd_sum(float const*, long, "
                  "float*)"):
        assert trace_step.port_kernel(stage) == "nb_elbo_fwd"
    assert trace_step.port_kernel(
        "nbk::reduce_parts(float const*, long, long, int, float*, long)"
    ) == "torch"


def test_port_kernel_names_elbo_stages():
    """Every instance of K7's stage 1 (dtype x with_const x on-chip or
    re-read) and of K8 (dtype x vector loads) is its kernel's time; the
    earlier names no longer match."""
    for dtype in ("signed char", "short", "float"):
        for const in ("false", "true"):
            for onchip in ("false", "true"):
                assert trace_step.port_kernel(
                    f"void (anonymous namespace)::elbo_fwd_rows<{dtype}, "
                    f"{const}, {onchip}>({dtype} const*, float const*, "
                    f"float const*, float const*, long, long, long, float*)"
                ) == "nb_elbo_fwd"
        for vec in ("false", "true"):
            assert trace_step.port_kernel(
                f"void (anonymous namespace)::elbo_bwd_groups<{dtype}, "
                f"{vec}>(float const*, {dtype} const*)") == "nb_elbo_bwd"
    for old in ("void (anonymous namespace)::elbo_fwd_kernel<float, true>"
                "(float const*)",
                "void (anonymous namespace)::elbo_bwd_kernel<short>(float "
                "const*)"):
        assert trace_step.port_kernel(old) == "torch"


def test_port_kernel_names_value_and_finish_stages():
    """Both stages of K6 (``csrc/nb_value.cu``) are K6's time and both
    stages of K3 (``csrc/nb_finish.cu``) K3's, in every instance."""
    for stage in ("void (anonymous namespace)::value_tiles<signed char, "
                  "2, 1, 1, true, false>(signed char const*)",
                  "void (anonymous namespace)::value_tiles<float, 0, 0, 0, "
                  "true, true>(float const*)",
                  "(anonymous namespace)::value_sum(float const*, long, "
                  "float*)"):
        assert trace_step.port_kernel(stage) == "nb_value"
    for stage in ("void (anonymous namespace)::finish_tiles<2, 1>(float "
                  "const*)",
                  "void (anonymous namespace)::finish_tiles<0, 0>(float "
                  "const*)",
                  "(anonymous namespace)::finish_sum(float const*, float "
                  "const*, long, long, int, long, int, int, long, long, "
                  "float*, float*)"):
        assert trace_step.port_kernel(stage) == "nb_finish"


def test_port_kernel_names_encoder_forward_stages():
    """Both stages of the encoder forward (``csrc/count_encode.cu``) are
    K4's time in the table; its backward stays apart."""
    for stage in ("void (anonymous namespace)::count_encode_tiles<signed "
                  "char, 16, 4, true, true>(signed char const*, long)",
                  "(anonymous namespace)::count_encode_sum(float const*, "
                  "long, long, int, int, int, bool, float*)"):
        assert trace_step.port_kernel(stage) == "count_encode"
    assert trace_step.port_kernel(
        "void (anonymous namespace)::count_encode_bwd_tiles<signed char, "
        "2, 2>(signed char const*)") == "count_encode_bwd"


def test_port_kernel_names_bwd_and_lse_stages():
    """Both stages of K5 (``csrc/count_encode_bwd.cu``) are K5's time in
    the table and both stages of K1 (``csrc/nb_lse.cu``) K1's, in every
    instance; neither is taken for the encoder forward's or K2's."""
    for stage in ("void (anonymous namespace)::count_encode_bwd_tiles<"
                  "float, 0, 0>(float const*, long)",
                  "void (anonymous namespace)::count_encode_bwd_tiles<"
                  "short, 12, 3>(short const*, long)",
                  "(anonymous namespace)::count_encode_bwd_sum(float "
                  "const*, long, int, int, long, float*, float*)"):
        assert trace_step.port_kernel(stage) == "count_encode_bwd"
    for stage in ("void (anonymous namespace)::lse_tiles<3>(float const*, "
                  "float const*, long, long, int, float*)",
                  "void (anonymous namespace)::lse_tiles<0>(float const*)",
                  "(anonymous namespace)::lse_sum(float const*, long, long, "
                  "float*)"):
        assert trace_step.port_kernel(stage) == "nb_lse"


def test_import_guard_walks_the_benchmarks():
    """``tests/test_torch_serve.py::test_port_serving_imports_no_jax``
    imports every module ``walk_packages`` finds: the port's benchmark
    scripts are among them."""
    names = {m.name for m in pkgutil.walk_packages(
        mmvae_tpu_torch.__path__, "mmvae_tpu_torch.")}
    assert {"mmvae_tpu_torch.benchmarks",
            "mmvae_tpu_torch.benchmarks.valgrad_roofline",
            "mmvae_tpu_torch.benchmarks.trace_step",
            "mmvae_tpu_torch.utils.profiling",
            "mmvae_tpu_torch.utils.summary"} <= names
