# Frozen copy of mppiisaac_tpu_torch/mppi/sampling.py, part of the benchmark's yardstick.
"""Noise sampling for MPPI: Halton low-discrepancy + Gaussian, and the
halton-spline reduced-basis scheme (knot sampling + B-spline interpolation
across the horizon — the reference's `mppi_mode: halton-spline`, SURVEY §5
'long-context' note: smoothness via reduced basis, not horizon parallelism).

The Halton core replaces the reference's native `ghalton` C++ dep (SURVEY
§2.2). Sequences are deterministic → precomputed host-side once per
(K, dims) and kept on the device as constants.
"""
from __future__ import annotations

import numpy as np

def _primes(k: int) -> np.ndarray:
    """First k primes (sieve, grown geometrically). The reference's ghalton
    has no dimension cap; neither do we — long-horizon simple-mode sampling
    needs H·nu distinct bases or noise correlates across the horizon."""
    if k <= 0:
        return np.zeros(0, np.int64)
    limit = max(32, int(k * (np.log(max(k, 6)) + np.log(np.log(max(k, 6)))) * 1.2))
    while True:
        sieve = np.ones(limit + 1, bool)
        sieve[:2] = False
        for p in range(2, int(limit ** 0.5) + 1):
            if sieve[p]:
                sieve[p * p :: p] = False
        ps = np.nonzero(sieve)[0]
        if len(ps) >= k:
            return ps[:k].astype(np.int64)
        limit *= 2


def _halton_numpy(n: int, dims: int, skip: int = 1) -> np.ndarray:
    """Scrambled (generalized) Halton, numpy path — identical algorithm to
    csrc/halton.cpp. Digits are multiplicatively scrambled per dimension:
    π_b(d) = (d · m_b) mod b with m_b ≈ 0.618·b (golden-ratio stride). Plain
    Halton degenerates for primes > n (consecutive indices cluster within a
    1/b-wide band); scrambling equidistributes every dimension — the same fix
    the reference's `ghalton` applies via digit permutations."""
    primes = _primes(dims)
    out = np.empty((n, dims))
    idx = np.arange(skip, skip + n, dtype=np.int64)
    for d in range(dims):
        b = int(primes[d])
        m = max(1, int(b * 0.61803398875))
        r = np.zeros(n)
        f = 1.0
        i = idx.copy()
        while i.max() > 0:
            f /= b
            r += f * ((i % b) * m % b)
            i //= b
        out[:, d] = r
    # keep strictly inside (0,1) for the normal inverse CDF
    return np.clip(out, 1e-6, 1 - 1e-6)


def halton(n: int, dims: int, skip: int = 1) -> np.ndarray:
    """(n, dims) uniform low-discrepancy points in (0,1). No dimension cap.
    The numpy path is the whole implementation here; the native core of the
    reference package is a host speed-up with the same digits."""
    return _halton_numpy(n, dims, skip)


def _ndtri(u: np.ndarray) -> np.ndarray:
    """Inverse standard normal CDF (Acklam's rational approximation, ~1e-9)."""
    a = [-3.969683028665376e+01, 2.209460984245205e+02, -2.759285104469687e+02,
         1.383577518672690e+02, -3.066479806614716e+01, 2.506628277459239e+00]
    b = [-5.447609879822406e+01, 1.615858368580409e+02, -1.556989798598866e+02,
         6.680131188771972e+01, -1.328068155288572e+01]
    c = [-7.784894002430293e-03, -3.223964580411365e-01, -2.400758277161838e+00,
         -2.549732539343734e+00, 4.374664141464968e+00, 2.938163982698783e+00]
    d = [7.784695709041462e-03, 3.224671290700398e-01, 2.445134137142996e+00,
         3.754408661907416e+00]
    plow, phigh = 0.02425, 1 - 0.02425
    u = np.clip(u, 1e-12, 1 - 1e-12)
    x = np.empty_like(u)
    lo = u < plow
    hi = u > phigh
    mid = ~(lo | hi)
    if lo.any():
        q = np.sqrt(-2 * np.log(u[lo]))
        x[lo] = (((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q + c[5]) / (
            (((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1
        )
    if hi.any():
        q = np.sqrt(-2 * np.log(1 - u[hi]))
        x[hi] = -(((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q + c[5]) / (
            (((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1
        )
    if mid.any():
        q = u[mid] - 0.5
        r = q * q
        x[mid] = (((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4]) * r + a[5]) * q / (
            ((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r + b[4]) * r + 1
        )
    return x


def halton_normal(n: int, dims: int, skip: int = 1) -> np.ndarray:
    """Low-discrepancy standard-normal points (n, dims)."""
    return _ndtri(halton(n, dims, skip))


def bspline_interp_matrix(n_knots: int, horizon: int, degree: int = 2) -> np.ndarray:
    """(horizon, n_knots) matrix P: noise_t = P @ knot_noise.

    Clamped uniform B-spline basis evaluated at `horizon` equally spaced
    parameters — smooth trajectories from few random DOFs (the halton-spline
    reduced basis). Rows sum to 1 (partition of unity), so knot-noise variance
    is preserved up to the basis overlap factor.
    """
    if n_knots <= degree:
        degree = max(1, n_knots - 1)
    # clamped knot vector
    m = n_knots + degree + 1
    kv = np.concatenate([
        np.zeros(degree + 1),
        np.arange(1, n_knots - degree) / (n_knots - degree),
        np.ones(degree + 1),
    ])
    assert len(kv) == m, (len(kv), m)

    def basis(i, p, t):
        if p == 0:
            if kv[i] <= t < kv[i + 1]:
                return 1.0
            if t >= 1.0 and kv[i + 1] >= 1.0 and kv[i] < 1.0:
                return 1.0
            return 0.0
        out = 0.0
        den1 = kv[i + p] - kv[i]
        if den1 > 0:
            out += (t - kv[i]) / den1 * basis(i, p - 1, t)
        den2 = kv[i + p + 1] - kv[i + 1]
        if den2 > 0:
            out += (kv[i + p + 1] - t) / den2 * basis(i + 1, p - 1, t)
        return out

    ts = np.linspace(0, 1, horizon)
    P = np.zeros((horizon, n_knots))
    for r, t in enumerate(ts):
        for i in range(n_knots):
            P[r, i] = basis(i, degree, min(t, 1.0 - 1e-12))
    P /= P.sum(1, keepdims=True)
    return P


def savgol_coeffs(window: int, polyorder: int) -> np.ndarray:
    """Savitzky–Golay smoothing coefficients (central), window odd."""
    half = window // 2
    x = np.arange(-half, half + 1, dtype=np.float64)
    A = np.vander(x, polyorder + 1, increasing=True)   # (window, p+1)
    # projection onto polynomial space evaluated at 0 → first row of pinv
    return np.linalg.pinv(A)[0]


def savgol_matrix(coeffs: np.ndarray, H: int) -> np.ndarray:
    """The (H, H) matrix M with M @ U the Savitzky–Golay window `coeffs`
    over the rows of U (H, n) padded at each end with copies of its edge
    rows: row t holds coeffs[w] at column clip(t + w − half, 0, H − 1),
    summed where the padding folds several taps onto one edge row."""
    half = len(coeffs) // 2
    M = np.zeros((H, H), np.float64)
    for t in range(H):
        for w, cw in enumerate(np.asarray(coeffs, np.float32).astype(np.float64)):
            M[t, min(max(t + w - half, 0), H - 1)] += cw
    return M
