"""The yardstick of the kernels' roofline shares, frozen.

Copied from ``chip_smoke.py`` (the peaks at lines 282-283, the operation
and byte counts at lines 622-697): the published fp32 rate outside the
tensor cores and the HBM rate of one H100 SXM, and the work of a call
counted from its shapes, each input read once and each output written once.
A call's bound is the larger of operations over the fp32 peak and bytes
over the memory rate; a share of it is bound time over measured time."""
from __future__ import annotations

from typing import NamedTuple

PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


class BBT(NamedTuple):
    """The bordered block-tridiagonal shape of a boxADMM KKT: S diagonal
    blocks of order k, nx boundary states coupling neighbours, border a."""
    S: int
    k: int
    nx: int
    a: int


def bound(flops, nbytes):
    """Least time in seconds, and which count bounds it."""
    tf, tb = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return max(tf, tb), ("operations" if tf >= tb else "bytes")


def flops_factor(K):
    """Unpivoted LDL^T of one symmetric K x K matrix: at each pivot the
    rank-1 update of the trailing lower triangle (n (n+1) / 2 multiply-adds
    for a trailing order n) and the n scalings of the column."""
    return sum(n * (n + 1) + n for n in range(1, K))


def flops_solve(K, nrhs=1):
    """Forward, diagonal and backward sweeps against a packed factor."""
    return nrhs * (2 * K * (K - 1) + K)


def flops_bbt_factor(st: BBT):
    S, k, nx, a = st.S, st.k, st.nx, st.a
    f = 2 * a ** 3
    for s in range(S):
        if s > 0:
            f += 2 * (k * nx * nx + a * k * nx + k * k * nx)
        f += flops_factor(k) + flops_solve(k, nx + a) + 2 * a * a * k
    return f


def flops_bbt_solve(st: BBT):
    S, k, nx, a = st.S, st.k, st.nx, st.a
    return (S * flops_solve(k) + 4 * (S - 1) * k * nx + 4 * S * a * k
            + 2 * a * a)


def bbt_bytes(st: BBT, nvec):
    return 4 * (st.S * st.k * (st.k + st.nx + st.a) + st.a * st.a
                + nvec * (st.S * st.k + st.a))


def bound_bbt_epoch(st: BBT, B, iters):
    """One boxADMM epoch on B lanes: the block factor and ``iters``
    iterations (a block solve and ~15 vector operations on each of the
    S k + a unknowns), 11 vectors in and out."""
    L = st.S * st.k + st.a
    f = flops_bbt_factor(st) + iters * (flops_bbt_solve(st) + 15 * L)
    return bound(B * f, B * bbt_bytes(st, 11))


def bound_ldlt(kind, B, K):
    f = {"factor": flops_factor(K), "solve": flops_solve(K),
         "factor_solve": flops_factor(K) + flops_solve(K)}[kind]
    nb = {"factor": 2 * K * K + K, "solve": K * K + 3 * K,
          "factor_solve": 2 * K * K + 3 * K}[kind]
    return bound(B * f, B * 4 * nb)


def bound_newton_solve(B, K, ir):
    """One float32 Newton-KKT solve of the certify: a factor and solve,
    then ``ir`` refinement sweeps, each a residual product r - M x
    (2 K^2 operations; M, x and r read, the residual written) and a solve,
    in the arithmetic of :func:`bound_ldlt`."""
    flops = (flops_factor(K) + flops_solve(K)
             + ir * (2 * K * K + flops_solve(K)))
    words = (2 * K * K + 3 * K) + ir * ((K * K + 3 * K) + (K * K + 3 * K))
    return bound(B * flops, B * 4 * words)
