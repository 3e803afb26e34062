"""Byte-size and metric-prefix formatting.

Parity: unit::byte + prefix printing (schwarzwald/util/types/Units.h:8-29)
and the metric formatting used by the LAS benchmark output.
"""
from __future__ import annotations

_BINARY = [("TiB", 1 << 40), ("GiB", 1 << 30), ("MiB", 1 << 20),
           ("KiB", 1 << 10)]
_METRIC = [("T", 10 ** 12), ("G", 10 ** 9), ("M", 10 ** 6), ("K", 10 ** 3)]


def format_bytes(n: float, binary: bool = True) -> str:
    table = _BINARY if binary else [(p + "B", v) for p, v in _METRIC]
    for suffix, factor in table:
        if abs(n) >= factor:
            return f"{n / factor:.2f} {suffix}"
    return f"{n:.0f} B"


def format_metric(n: float, unit: str = "") -> str:
    for prefix, factor in _METRIC:
        if abs(n) >= factor:
            return f"{n / factor:.2f} {prefix}{unit}"
    return f"{n:.2f} {unit}"
