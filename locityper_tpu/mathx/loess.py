"""LOESS local polynomial regression (counterpart of reference algo/loess.rs:23-175).

Tricube-weighted local polynomial fit, evaluated at user-specified output
points.  Used by the GC-conditional read-depth model (bg/depth.rs:69-91) on
tiny data (~hundreds of windows), so a plain vectorized numpy implementation
is appropriate; there is nothing for the device to accelerate here.
"""
from __future__ import annotations

import numpy as np


def loess(x, y, xout, frac: float = 0.5, degree: int = 1, weights=None) -> np.ndarray:
    """For each x0 in `xout`, fits a weighted polynomial of degree `degree`
    over the `ceil(frac * n)` nearest points, with tricube distance weights
    (optionally multiplied by observation `weights`), and evaluates at x0.
    """
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    xout = np.asarray(xout, dtype=np.float64)
    n = x.size
    assert n == y.size and n > 0
    q = max(int(np.ceil(frac * n)), degree + 1)
    q = min(q, n)
    obs_w = np.ones(n) if weights is None else np.asarray(weights, dtype=np.float64)

    out = np.empty(xout.size)
    for i, x0 in enumerate(xout):
        d = np.abs(x - x0)
        idx = np.argpartition(d, q - 1)[:q]
        dmax = np.max(d[idx])
        if dmax <= 0:
            out[i] = np.average(y[idx], weights=obs_w[idx])
            continue
        u = d[idx] / dmax
        w = np.clip(1.0 - u ** 3, 0.0, None) ** 3 * obs_w[idx]
        wsum = w.sum()
        if wsum <= 0:
            out[i] = float(np.mean(y[idx]))
            continue
        # Weighted polynomial fit via lstsq on sqrt(w)-scaled Vandermonde.
        xv = x[idx] - x0
        V = np.vander(xv, degree + 1, increasing=True)
        sw = np.sqrt(w)
        coef, *_ = np.linalg.lstsq(V * sw[:, None], y[idx] * sw, rcond=None)
        out[i] = coef[0]
    return out
