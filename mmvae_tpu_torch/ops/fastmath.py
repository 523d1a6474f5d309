"""Bit-exact Python ports of the Mineiro fast-math scalars the reference
bakes into its loss constants.

The reference evaluates a few *additive constants* with crude
bit-twiddling approximations rather than exact math — notably
``fasterlog(2*pi)`` in the vMF likelihood (include/models/vmf.hh:437,
~2.5% off the true log) and ``fasterlgamma(df+1)`` inside lbessel
(include/operators.hh:75).  These have zero gradient, but they shift the
*reported* loss, so value-level parity with the reference's scores
requires reproducing them exactly.  Formulas from
include/utils/fastlog.h:64-84 and include/utils/fastgamma.h:59-61.
"""

from __future__ import annotations

import struct


def _bits(x: float) -> int:
    return struct.unpack("<I", struct.pack("<f", x))[0]


def _f32(x: float) -> float:
    return struct.unpack("<f", struct.pack("<f", x))[0]


def fasterlog(x: float) -> float:
    """float fasterlog(float): y = (float)bits(x) * 8.2629582881927490e-8
    - 87.989971088 (fastlog.h:74-84)."""
    # note: C first rounds the 32-bit pattern into a float32 (`float y
    # = vx.i`), losing low bits — reproduce that rounding
    y = _f32(_f32(float(_bits(_f32(x)))) * _f32(8.2629582881927490e-8))
    return _f32(y - _f32(87.989971088))


def fasterlgamma(x: float) -> float:
    """float fasterlgamma(float) (fastgamma.h:59-61); every intermediate
    rounds to float32, matching C's left-to-right evaluation."""
    x = _f32(x)
    acc = _f32(_f32(-0.0810614667) - x)
    acc = _f32(acc - fasterlog(x))
    prod = _f32(_f32(_f32(0.5) + x) * fasterlog(_f32(_f32(1.0) + x)))
    return _f32(acc + prod)
