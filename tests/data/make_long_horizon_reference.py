"""Regenerate ``long_horizon_jax_cpu.npz``: the JAX package's record of the
long-horizon batch (polympc_torch/long_horizon_point.py), for the CUDA
port to be held against on a machine that has no JAX.

The damped pendulum of tests/test_long_horizon.py on S = 512 Chebyshev(4)
segments of 0.5 s (t in [0, 256] s); B = 32 initial states, lane 0 at
(2, 0) and lanes 1-31 uniform on [-2, 2] x [-1, 1] from
``default_rng(5)``; ``solve_long_horizon`` in float64, 12 Newton steps,
lane by lane.  The record holds:

  * ``x0s`` (32, 2);
  * ``defect``, ``continuity`` (12, 32): every lane's ``hist``;
  * ``boundary`` (32, 512, 2): the states at each segment's last node,
    X[:, :, -1, :];
  * ``Z01`` (2, 512, 15): the whole solution of lanes 0 and 1.

Run from the repository root (about a minute on an 8-core CPU):

    python tests/data/make_long_horizon_reference.py
"""
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp  # noqa: E402

SEGMENTS = 512
LANES = 32
ORDER = 4
SEG_LEN = 0.5
ITERS = 12
SEED = 5
FULL_LANES = 2


def lane_x0s():
    """The harness's draw (long_horizon_point.lane_x0s), float64."""
    rng = np.random.default_rng(SEED)
    rest = np.stack([rng.uniform(-2.0, 2.0, LANES - 1),
                     rng.uniform(-1.0, 1.0, LANES - 1)], axis=1)
    return np.concatenate([[[2.0, 0.0]], rest]).astype(np.float64)


def pendulum_ocp():
    from polympc_tpu.ocp.ocp import OCP

    def dyn(x, u, p, d, t):
        return jnp.array([x[1], -jnp.sin(x[0]) - 0.2 * x[1] + u[0]])

    def lag(x, u, p, d, t):
        return x @ x + 0.1 * (u @ u)

    return OCP(nx=2, nu=1, dynamics=dyn, lagrange=lag)


def solve_lanes(x0s):
    """Every lane through the JAX package's ``solve_long_horizon``:
    (defect (iters, B), continuity (iters, B), Z (B, S, nz), lh)."""
    from polympc_tpu.basis import Chebyshev
    from polympc_tpu.parallel.long_horizon import (
        LongHorizon, solve_long_horizon)
    lh = LongHorizon(pendulum_ocp(), Chebyshev(ORDER), S=SEGMENTS, t0=0.0,
                     tf=SEG_LEN * SEGMENTS)
    defect, cont, Zs = [], [], []
    for x0 in x0s:
        Z, _, hist = solve_long_horizon(lh, x0=x0, iters=ITERS)
        defect.append([h["defect"] for h in hist])
        cont.append([h["continuity"] for h in hist])
        Zs.append(np.asarray(Z))
    return (np.asarray(defect).T, np.asarray(cont).T, np.stack(Zs), lh)


def main():
    t0 = time.perf_counter()
    x0s = lane_x0s()
    defect, cont, Z, lh = solve_lanes(x0s)
    X = Z[:, :, :lh.ne].reshape(LANES, SEGMENTS, lh.N, lh.nx)
    out = os.path.join(HERE, "long_horizon_jax_cpu.npz")
    np.savez(out, x0s=x0s, defect=defect, continuity=cont,
             boundary=X[:, :, -1, :], Z01=Z[:FULL_LANES])
    print(f"wrote {out} ({os.path.getsize(out)} bytes) in "
          f"{time.perf_counter() - t0:.1f} s; final defect max "
          f"{defect[-1].max():.3e}, continuity max {cont[-1].max():.3e}")


if __name__ == "__main__":
    main()
