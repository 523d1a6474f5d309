"""The FLOP count and the kernels' work table against the
configurations' shapes, worked out by hand here."""

import json
import os

import pytest

from perfbench import flops, roofline
from perfbench.models import nb as nb_build
from perfbench.models import vmfnb as vmfnb_build

from .conftest import REPO


def _cfg(name):
    return json.load(open(os.path.join(REPO, "perfbench", "configs",
                                       f"{name}.json")))


def test_nb_step_flops():
    cfg = _cfg("nb_default")
    # forward: 2 B (D R + 2 R R + C R + D H + 2 H Rn + D + R D + C D + Rn D)
    B, D = 100, 20000
    fwd = 2 * B * (D * 2 + 2 * 4 + 2 + D + 2 + D + 2 * D + D + D)
    assert flops.forward_flops(nb_build.matmuls(cfg), B) == fwd
    assert flops.step_flops(nb_build.matmuls(cfg), B, 3) == fwd * 10
    assert fwd * 10 == pytest.approx(320.02e6, rel=1e-4)


def test_vmfnb_step_flops():
    cfg = _cfg("vmfnb_default")
    B, D = 100, 20000
    # shared encoder D R, heads 2 R R, nu encoder D H, heads 2 H Rn,
    # depth D, kappa D, NB decoder R D, nu decoder Rn D, vMF decoder R D
    fwd = 2 * B * (2 * D + 8 + D + 2 + D + D + 2 * D + D + 2 * D)
    assert flops.forward_flops(vmfnb_build.matmuls(cfg), B) == fwd
    assert flops.step_flops(vmfnb_build.matmuls(cfg), B, 3) == fwd * 10


def test_nb_kernel_shapes():
    calls = nb_build.kernel_calls(_cfg("nb_default"), 100, 1)
    k4 = calls["count_encode.launches"]
    assert k4[0] == "count_encode"
    assert (k4[1]["r1"], k4[1]["r2"], k4[1]["stats"]) == (2, 2, False)
    assert calls["value.launches"][1]["const"] is True
    assert all(s["M"] == 100 and s["D"] == 20000 and s["xb"] == 1
               for _, s in calls.values())


def test_vmfnb_kernel_shapes():
    calls = vmfnb_build.kernel_calls(_cfg("vmfnb_default"), 100, 1)
    k4 = calls["count_encode.stats_launches"][1]
    assert (k4["r1"], k4["r2"], k4["stats"]) == (5, 3, True)
    assert calls["valgrad.joint_launches"][1]["joint"] is True
    assert calls["lse.launches"][1]["C"] == 1


def test_encoder_work():
    s = dict(M=100, D=20000, xb=1, r1=2, r2=2, stats=False)
    ops, nbytes = roofline.work("count_encode", s)
    assert ops == 100 * 20000 * (1 + 2 * 4)
    assert nbytes == 100 * 20000 + 4 * 20000 * 4 + 100 * 4 * 4
    s = dict(s, r1=5, r2=3, stats=True)
    ops, nbytes = roofline.work("count_encode", s)
    assert ops == 100 * 20000 * (1 + 16 + 3)
    assert nbytes == 100 * 20000 + 8 * 20000 * 4 + 100 * 8 * 4 + 1600
    ops, nbytes = roofline.work("count_encode_bwd", s)
    assert ops == 100 * 20000 * 17
    assert nbytes == 100 * 20000 + 100 * 8 * 4 + 8 * 20000 * 4


def test_step_kernel_work():
    s = dict(M=100, D=20000, xb=1, R=2, C=1, Rn=1, joint=False)
    n = 100 * 20000
    # K1: logits 6, max, subtract, exp, add
    assert roofline.work("nb_lse", s) == (n * 10, 100 * 3 * 4
                                          + 4 * 20000 * 4 + 400)
    # K3: logits 6, subtract, exp, multiply, 3 FMAs, add, 2 FMAs
    assert roofline.work("nb_finish", s)[0] == n * 20
    # K6 reads x, the 6 stacked rows and 6 numbers a row, writes 4 bytes
    ops, nbytes = roofline.work("nb_value", dict(s, const=True))
    assert nbytes == n + 6 * 20000 * 4 + 6 * 100 * 4 + 4
    # the joint variant: one more stacked row, the post-softmax add, and
    # exp in place of softplus
    j = roofline.work("nb_value", dict(s, joint=True, const=True))
    assert j[1] == nbytes + 20000 * 4
    assert j[0] == ops + n * (1 - 1)
    k2 = roofline.work("nb_valgrad", s)
    assert k2[1] == n + 2 * 6 * 20000 * 4 + 6 * 100 * 4 + 100 * 4 * 4


@pytest.mark.parametrize("kernel", ["count_encode", "count_encode_bwd",
                                    "nb_lse", "nb_value", "nb_valgrad",
                                    "nb_finish"])
def test_least_time_is_the_larger_bound(kernel):
    s = dict(M=100, D=20000, xb=1, R=2, C=1, Rn=1, joint=False, r1=2,
             r2=2, stats=False, const=True)
    ops, nbytes = roofline.work(kernel, s)
    t, by = roofline.least_s(kernel, s)
    assert t == max(ops / roofline.PEAK_F32, nbytes / roofline.PEAK_BYTES)
    assert by in ("bytes", "operations")
