"""Latency statistics shared by the serve engine and its drivers."""

from __future__ import annotations


def percentile(sorted_values, p: float) -> float:
    """Nearest-rank percentile of an ascending list (0 for empty input)."""
    if not sorted_values:
        return 0.0
    i = min(int(p * (len(sorted_values) - 1)), len(sorted_values) - 1)
    return sorted_values[i]
