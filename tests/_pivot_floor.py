"""A synthetic certify-like Newton-KKT system whose unpivoted LDL^T factor
pivots on its 1e-6 regularisation (the situation of every lane of the kite
by multiple shooting): [[H + reg I, J'], [J, -reg I]] where the last two
primal variables carry no curvature and enter one row only, linearly.
Shared by the residual-gate tests on the CPU (tests/test_torch_ldlt_panels.py)
and on the card (tests/test_torch_cuda.py); numpy only, no JAX.
"""
import numpy as np


def pivot_floor_system(B, K, seed=0, coupling=1e-2, reg=1e-6):
    """(M (B, K, K), b (B, K)) float64 numpy: n = 3K/5 primals, the rest
    rows; the first n-2 primals a positive definite block, the last two
    only the regularisation and a ``coupling`` entry in row 0."""
    rng = np.random.default_rng(seed)
    n = K * 3 // 5
    m = K - n
    G = rng.normal(size=(B, n - 2, n - 2))
    H = np.zeros((B, n, n))
    H[:, :n - 2, :n - 2] = G @ G.transpose(0, 2, 1) / n + np.eye(n - 2)
    H += reg * np.eye(n)
    J = rng.normal(size=(B, m, n)) * 0.3
    J[:, :, n - 2:] = 0.0
    J[:, 0, n - 2:] = coupling
    M = np.zeros((B, K, K))
    M[:, :n, :n] = H
    M[:, :n, n:] = J.transpose(0, 2, 1)
    M[:, n:, :n] = J
    M[:, n:, n:] = -reg * np.eye(m)
    return M, rng.normal(size=(B, K))
