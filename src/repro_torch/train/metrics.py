"""Metrics of congestion prediction (paper Sec. 4.1): Pearson, Spearman,
Kendall, MAE and RMSE, plus the latency statistics shared by the serve
engine and its drivers.  Numpy only (the port's own copy)."""

from __future__ import annotations

import numpy as np


def percentile(sorted_values, p: float) -> float:
    """Nearest-rank percentile of an ascending list (0 for empty input)."""
    if not sorted_values:
        return 0.0
    i = min(int(p * (len(sorted_values) - 1)), len(sorted_values) - 1)
    return sorted_values[i]


def median(values) -> float:
    """Midpoint-averaging median (exact for even n; 0 for empty input)."""
    s = sorted(values)
    n = len(s)
    if not n:
        return 0.0
    if n % 2:
        return float(s[n // 2])
    return 0.5 * (float(s[n // 2 - 1]) + float(s[n // 2]))


def pearson(pred, label) -> float:
    p, l = np.asarray(pred, np.float64), np.asarray(label, np.float64)
    p, l = p - p.mean(), l - l.mean()
    den = np.sqrt((p * p).sum() * (l * l).sum())
    return float((p * l).sum() / den) if den > 0 else 0.0


def _ranks(x):
    """Ranks from 0, ties given their midrank."""
    x = np.asarray(x)
    order = np.argsort(x, kind="stable")
    r = np.empty(len(x), np.float64)
    r[order] = np.arange(len(x))
    xs = x[order]
    i = 0
    while i < len(xs):
        j = i
        while j + 1 < len(xs) and xs[j + 1] == xs[i]:
            j += 1
        if j > i:
            r[order[i:j + 1]] = (i + j) / 2.0
        i = j + 1
    return r


def spearman(pred, label) -> float:
    return pearson(_ranks(pred), _ranks(label))


def kendall(pred, label, max_n: int = 2000, seed: int = 0) -> float:
    """Kendall tau-b; subsampled above ``max_n`` (O(n²) pairs)."""
    p, l = np.asarray(pred, np.float64), np.asarray(label, np.float64)
    if len(p) > max_n:
        idx = np.random.default_rng(seed).choice(len(p), max_n, replace=False)
        p, l = p[idx], l[idx]
    dp = np.sign(p[:, None] - p[None, :])
    dl = np.sign(l[:, None] - l[None, :])
    iu = np.triu_indices(len(p), 1)
    conc = dp[iu] * dl[iu]
    n0 = len(conc)
    tp = (dp[iu] == 0).sum()
    tl = (dl[iu] == 0).sum()
    den = np.sqrt((n0 - tp) * (n0 - tl))
    return float(conc.sum() / den) if den > 0 else 0.0


def mae(pred, label) -> float:
    return float(np.abs(np.asarray(pred) - np.asarray(label)).mean())


def rmse(pred, label) -> float:
    return float(np.sqrt(((np.asarray(pred) - np.asarray(label)) ** 2).mean()))


def all_metrics(pred, label) -> dict:
    return dict(pearson=pearson(pred, label), spearman=spearman(pred, label),
                kendall=kendall(pred, label), mae=mae(pred, label),
                rmse=rmse(pred, label))
