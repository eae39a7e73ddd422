"""A faithful GSL-QAG / QUADPACK qage reimplementation with the GK61 rule.

The reference evaluates sigma^2(M), dsigma^2/dM and the photon-conservation
Nion integrals with gsl_integration_qag(..., GSL_INTEG_GAUSS61)
(cosmology.c:389,441; hmf.c:628).  GSL's qag IS QUADPACK's qage: apply the
61-point Gauss-Kronrod rule, then repeatedly bisect the subinterval with the
largest error estimate until the summed estimate meets
max(epsabs, epsrel*|result|).

For smooth integrands any quadrature agrees and this module is mostly a
cross-check — production uses tabulated sigma.  It was built to test
whether the photon-conservation gold's dsigma^2/dM inflation is the
catastrophic-cancellation noise of dwdm_filter (filtering.c:49-78) AS
SAMPLED BY GK61 UNDER QAG SUBDIVISION.  Negative result: this faithful
qage converges cleanly to the stable value at the reference's own
tolerances (models/photoncons._dsig2_unstable documents the consequence) —
so the module now serves as an independent integrator for validation work
and as the recorded evidence for that conclusion.

The GK61 nodes/weights are constructed at import from first principles:
Kronrod nodes are the roots of the Stieltjes polynomial E_31 (orthogonal to
all lower degrees against the weight P_30 on [-1,1]) and weights come from
exactness on the Legendre basis; both reproduce the published QUADPACK dqk61
constants to ~1e-14 (spot-checked against scipy's fixed-rule values where
available).
"""

from __future__ import annotations

import heapq

import numpy as np

__all__ = ["gauss_kronrod_61", "qk61", "qag_gk61"]

_EPMACH = np.finfo(np.float64).eps
_UFLOW = np.finfo(np.float64).tiny


def _kronrod_nodes_weights(n: int = 30):
    """(x_gk[2n+1], w_gk[2n+1], w_g[n]) for the Gauss-Kronrod (2n+1) rule."""
    from numpy.polynomial import legendre as L

    # Stieltjes polynomial E_{n+1} = P_{n+1} + sum_{i<n+1, same parity} c_i P_i,
    # fixed by int P_n E_{n+1} P_j dx = 0 for j = 0..n-1.
    deg_quad = 2 * n + 60
    xq, wq = L.leggauss(deg_quad)

    def P(i, x):
        c = np.zeros(i + 1)
        c[i] = 1.0
        return L.legval(x, c)

    Pn = P(n, xq)
    # parity: E_{n+1} has parity of n+1; basis indices i = (n+1)%2, step 2, i<n+1
    basis = list(range((n + 1) % 2, n + 1, 2))
    # conditions: j with parity such that P_n*P_{n+1}*P_j even -> j parity = (n+1+n)%2
    conds = list(range((2 * n + 1) % 2, n, 2))
    A = np.empty((len(conds), len(basis)))
    rhs = np.empty(len(conds))
    for r, j in enumerate(conds):
        Pj = P(j, xq)
        for c_i, i in enumerate(basis):
            A[r, c_i] = np.sum(wq * Pn * P(i, xq) * Pj)
        rhs[r] = -np.sum(wq * Pn * P(n + 1, xq) * Pj)
    coef = np.linalg.solve(A, rhs)

    e_coef = np.zeros(n + 2)
    e_coef[n + 1] = 1.0
    for c_i, i in enumerate(basis):
        e_coef[i] = coef[c_i]
    x_new = np.sort(L.legroots(e_coef))          # n+1 Kronrod-only nodes
    x_gauss = np.sort(L.leggauss(n)[0])          # n Gauss nodes
    x_all = np.sort(np.concatenate([x_new, x_gauss]))

    # weights: exactness on P_0..P_{2n} (the rule is exact far beyond; the
    # square system is non-singular and consistent)
    V = np.empty((2 * n + 1, 2 * n + 1))
    for j in range(2 * n + 1):
        V[j] = P(j, x_all)
    b = np.zeros(2 * n + 1)
    b[0] = 2.0
    w_all = np.linalg.solve(V, b)
    w_g = L.leggauss(n)[1]
    return x_all, w_all, x_gauss, w_g


_XGK, _WGK, _XG, _WG = _kronrod_nodes_weights(30)
# Gauss nodes' positions inside the Kronrod node array (for the embedded sum)
_G_IDX = np.searchsorted(_XGK, _XG)


def gauss_kronrod_61():
    """(kronrod_nodes, kronrod_weights, gauss_weights_on_embedded_nodes)."""
    return _XGK, _WGK, _WG


def qk61(f, a, b):
    """One 61-point Gauss-Kronrod panel on [a, b]: QUADPACK dqk61.

    Returns (result, abserr, resabs, resasc)."""
    hlgth = 0.5 * (b - a)
    centr = 0.5 * (a + b)
    x = centr + hlgth * _XGK
    fv = np.array([f(xi) for xi in x])
    resk = float(np.dot(_WGK, fv))
    resg = float(np.dot(_WG, fv[_G_IDX]))
    reskh = resk * 0.5
    resabs = float(np.dot(_WGK, np.abs(fv)))
    resasc = float(np.dot(_WGK, np.abs(fv - reskh)))
    result = resk * hlgth
    resabs *= abs(hlgth)
    resasc *= abs(hlgth)
    abserr = abs((resk - resg) * hlgth)
    if resasc != 0.0 and abserr != 0.0:
        abserr = resasc * min(1.0, (200.0 * abserr / resasc) ** 1.5)
    if resabs > _UFLOW / (50.0 * _EPMACH):
        abserr = max(_EPMACH * 50.0 * resabs, abserr)
    return result, abserr, resabs, resasc


def qag_gk61(f, a, b, epsabs=0.0, epsrel=1e-6, limit=1000):
    """QUADPACK qage with the GK61 rule: bisect the largest-error interval
    until sum(errors) <= max(epsabs, epsrel*|sum(results)|).

    Mirrors gsl_integration_qag(..., GSL_INTEG_GAUSS61) including the
    roundoff bailouts; returns (result, abserr).  No extrapolation — this is
    deliberately qag, not scipy's qags."""
    result, abserr, resabs, resasc = qk61(f, a, b)
    errbnd = max(epsabs, epsrel * abs(result))
    if (abserr <= 100.0 * _EPMACH * resabs and abserr > errbnd) or (
        abserr <= errbnd
    ) or abserr == 0.0:
        return result, abserr

    # heap of (-error, seq, a, b, result) — largest error first
    heap = [(-abserr, 0, a, b, result)]
    area = result
    errsum = abserr
    iroff1 = iroff2 = 0
    for it in range(1, limit):
        neg_err, _, a1, b2, r_old = heapq.heappop(heap)
        e_old = -neg_err
        mid = 0.5 * (a1 + b2)
        r1, e1, _, s1 = qk61(f, a1, mid)
        r2, e2, _, s2 = qk61(f, mid, b2)
        area12 = r1 + r2
        erro12 = e1 + e2
        errsum += erro12 - e_old
        area += area12 - r_old
        if s1 != e1 and s2 != e2:
            if abs(r_old - area12) <= 1e-5 * abs(area12) and erro12 >= 0.99 * e_old:
                iroff1 += 1
            if it >= 10 and erro12 > e_old:
                iroff2 += 1
        heapq.heappush(heap, (-e1, 2 * it, a1, mid, r1))
        heapq.heappush(heap, (-e2, 2 * it + 1, mid, b2, r2))
        errbnd = max(epsabs, epsrel * abs(area))
        if errsum <= errbnd:
            break
        if iroff1 >= 6 or iroff2 >= 20:
            break  # GSL: GSL_EROUND; the accumulated estimate is returned
    return area, errsum
