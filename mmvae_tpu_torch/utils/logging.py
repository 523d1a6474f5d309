"""Timestamped stderr logging.

TPU-native analog of the reference's TLOG/WLOG/ELOG macros
(reference: include/utils/util.hh:20-33) -- timestamped messages on
stderr so training-progress output is line-for-line comparable.
"""

from __future__ import annotations

import sys
import time


def _stamp() -> str:
    return time.strftime("[%a %b %d %H:%M:%S %Y]")


def TLOG(*msg: object) -> None:
    print(_stamp(), *msg, file=sys.stderr, flush=True)


def WLOG(*msg: object) -> None:
    print(_stamp(), "[WARNING]", *msg, file=sys.stderr, flush=True)


def ELOG(*msg: object) -> None:
    print(_stamp(), "[ERROR]", *msg, file=sys.stderr, flush=True)
