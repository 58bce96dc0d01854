"""Parity of the port's Schur horizon condensation
(polympc_torch/parallel/horizon.py) with the JAX package's
(polympc_tpu/parallel/horizon.py, without a mesh) and with the dense oracle
``assemble_dense_horizon``, in float64.

Each case is a batch of B=2 lanes with different data: quasi-definite
segment KKTs [[H, A'], [A, -D]] of S=3 or S=8 segments, an interface
diagonal G (the ADMM-relaxed continuity rows) and optionally a global
border C/Dg/bg.  The JAX functions run lane by lane; the port takes the
batch.  ``schur_horizon_solve`` and ``schur_horizon_factor`` +
``schur_horizon_apply`` are held to 1e-10; the port's ``kkt_solver="kernel"``
(the plain ``ldlt_inverse`` on the CPU) against the JAX package's
``"pallas"`` (its Pallas kernel in interpret mode) at S=3.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _torch_parity import single_thread  # noqa: E402,F401
from polympc_tpu.parallel import horizon as jh  # noqa: E402
from polympc_torch.parallel import horizon as th  # noqa: E402

B = 2
TOL = 1e-10


def _lane(S, k, p, a, seed):
    """One lane: quasi-definite segment blocks (nz primal, k - nz dual),
    pick matrices on the primal part, G = -0.1 I, and a border when a > 0;
    numpy float64."""
    rng = np.random.default_rng(seed)
    nz = k - 4
    Hh = rng.normal(size=(S, nz, nz))
    H = Hh @ Hh.transpose(0, 2, 1) / nz + np.eye(nz)
    A = rng.normal(size=(S, k - nz, nz))
    K = np.zeros((S, k, k))
    K[:, :nz, :nz] = H
    K[:, :nz, nz:] = A.transpose(0, 2, 1)
    K[:, nz:, :nz] = A
    K[:, nz:, nz:] = -np.eye(k - nz) * rng.uniform(0.5, 2.0, (S, 1, 1))
    E = np.zeros((p, k))
    F = np.zeros((p, k))
    E[:, nz - p:nz] = np.eye(p)
    F[:, :p] = -np.eye(p)
    lane = {"K": K, "b": rng.normal(size=(S, k)),
            "c": rng.normal(size=(S - 1, p)) * 0.1,
            "G": np.tile(-0.1 * np.eye(p)[None], (S - 1, 1, 1)),
            "E": E, "F": F}
    if a:
        Dh = rng.normal(size=(a, a))
        lane.update(C=rng.normal(size=(S, k, a)) * 0.3,
                    Dg=Dh @ Dh.T + 0.5 * np.eye(a),
                    bg=rng.normal(size=(a,)))
    return lane


CASES = {"S3": (3, 12, 3, 0), "S3-border": (3, 12, 3, 2),
         "S8": (8, 16, 4, 0), "S8-border": (8, 16, 4, 1)}
BATCHED = ("K", "b", "c", "G", "C", "Dg", "bg")


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    S, k, p, a = CASES[request.param]
    lanes = [_lane(S, k, p, a, seed=10 * S + i + a) for i in range(B)]
    t = {n: torch.tensor(np.stack([ln[n] for ln in lanes]))
         for n in BATCHED if n in lanes[0]}
    return {"lanes": lanes, "t": t, "a": a}


def _border_kw(src, a):
    return {n: src[n] for n in ("C", "Dg", "bg")} if a else {}


def _jax_args(lane):
    return {n: jnp.asarray(v) for n, v in lane.items()}


def _check(got, lanes, ref_fn, tol=TOL):
    for i, ln in enumerate(lanes):
        for g, want in zip(got, ref_fn(ln)):
            np.testing.assert_allclose(g[i].numpy(), np.asarray(want),
                                       rtol=tol, atol=tol)


def test_solve_matches_jax_and_dense(case):
    lanes, t, a = case["lanes"], case["t"], case["a"]
    E, F = lanes[0]["E"], lanes[0]["F"]
    got = th.schur_horizon_solve(t["K"], t["b"], E, F, t["c"], G=t["G"],
                                 **_border_kw(t, a))
    assert len(got) == (3 if a else 2)

    def jax_ref(ln):
        j = _jax_args(ln)
        return jh.schur_horizon_solve(j["K"], j["b"], j["E"], j["F"], j["c"],
                                      G=j["G"], **_border_kw(j, a))

    _check(got, lanes, jax_ref)
    _check(got, lanes, lambda ln: th.assemble_dense_horizon(
        ln["K"], ln["b"], E, F, ln["c"], G=ln["G"], **_border_kw(ln, a)))


def test_factor_apply_matches_jax_and_dense(case):
    lanes, t, a = case["lanes"], case["t"], case["a"]
    E, F = lanes[0]["E"], lanes[0]["F"]
    kw = {"C": t["C"], "Dg": t["Dg"]} if a else {}
    fac = th.schur_horizon_factor(t["K"], E, F, G=t["G"], **kw)
    got = th.schur_horizon_apply(fac, t["b"], t["c"],
                                 bg=t["bg"] if a else None)

    def jax_ref(ln):
        j = _jax_args(ln)
        jkw = {"C": j["C"], "Dg": j["Dg"]} if a else {}
        jf = jh.schur_horizon_factor(j["K"], j["E"], j["F"], G=j["G"], **jkw)
        return jh.schur_horizon_apply(jf, j["b"], j["c"],
                                      bg=j["bg"] if a else None)

    _check(got, lanes, jax_ref)
    _check(got, lanes, lambda ln: th.assemble_dense_horizon(
        ln["K"], ln["b"], E, F, ln["c"], G=ln["G"], **_border_kw(ln, a)))
    # the factor's interface matrix is the Schur complement of the dense KKT
    for i, ln in enumerate(lanes):
        j = _jax_args(ln)
        jkw = {"C": j["C"], "Dg": j["Dg"]} if a else {}
        jf = jh.schur_horizon_factor(j["K"], j["E"], j["F"], G=j["G"], **jkw)
        np.testing.assert_allclose(fac["Minv"][i].numpy(),
                                   np.asarray(jf["Minv"]), rtol=TOL,
                                   atol=TOL)


@pytest.mark.parametrize("a", [0, 2], ids=["plain", "border"])
def test_kernel_route_matches_jax_pallas(a):
    """kkt_solver="kernel" (plain ldlt_inverse here) against the JAX
    package's "pallas" route (interpret mode) and against the "lu" route."""
    S, k, p = 3, 12, 3
    lanes = [_lane(S, k, p, a, seed=100 + i) for i in range(B)]
    t = {n: torch.tensor(np.stack([ln[n] for ln in lanes]))
         for n in BATCHED if n in lanes[0]}
    E, F = lanes[0]["E"], lanes[0]["F"]
    kw = {"C": t["C"], "Dg": t["Dg"]} if a else {}
    out = {}
    for solver in ("kernel", "lu"):
        fac = th.schur_horizon_factor(t["K"], E, F, G=t["G"],
                                      kkt_solver=solver, **kw)
        out[solver] = (fac, th.schur_horizon_apply(
            fac, t["b"], t["c"], bg=t["bg"] if a else None))

    def jax_ref(ln):
        j = _jax_args(ln)
        jkw = {"C": j["C"], "Dg": j["Dg"]} if a else {}
        jf = jh.schur_horizon_factor(j["K"], j["E"], j["F"], G=j["G"],
                                     kkt_solver="pallas", **jkw)
        return jh.schur_horizon_apply(jf, j["b"], j["c"],
                                      bg=j["bg"] if a else None)

    _check(out["kernel"][1], lanes, jax_ref)
    np.testing.assert_allclose(out["kernel"][0]["Kinv"].numpy(),
                               out["lu"][0]["Kinv"].numpy(), rtol=TOL,
                               atol=TOL)
    for g, w in zip(out["kernel"][1], out["lu"][1]):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=TOL, atol=TOL)


def test_interface_matrix_matches_jax_fori_loop(case):
    """The slice-assigned interface matrix equals the JAX package's
    fori_loop assembly, lane by lane."""
    lanes, t, a = case["lanes"], case["t"], case["a"]
    E, F = (torch.tensor(lanes[0][n]) for n in ("E", "F"))
    S = t["K"].shape[1]
    XE, XF, w0, XC = th._condense_local(t["K"], t["b"], E, F,
                                        t["C"] if a else None)
    Sloc = {"XE": XE, "XF": XF}
    if a:
        Sloc.update(XC=XC, C=t["C"])
    M = th._interface_matrix(Sloc, E, F, S, G=t["G"],
                             Dg=t["Dg"] if a else None)
    for i, ln in enumerate(lanes):
        j = _jax_args(ln)
        jS = {n: jnp.asarray(v[i].numpy()) for n, v in Sloc.items()}
        want = jh._interface_matrix(jS, j["E"], j["F"], S, G=j["G"],
                                    Dg=j["Dg"] if a else None)
        np.testing.assert_allclose(M[i].numpy(), np.asarray(want), rtol=0,
                                   atol=1e-13)


def test_single_segment_reduces_to_local_solve():
    """S=1: no interface; with a border only the border system remains."""
    rng = np.random.default_rng(5)
    k, p, a = 7, 3, 2
    Kh = rng.normal(size=(B, 1, k, k))
    K = torch.tensor(Kh @ Kh.transpose(0, 1, 3, 2) + 0.5 * np.eye(k))
    b = torch.tensor(rng.normal(size=(B, 1, k)))
    E = np.zeros((p, k))
    E[:, k - p:] = np.eye(p)
    F = np.zeros((p, k))
    F[:, :p] = -np.eye(p)
    c = torch.zeros((B, 0, p), dtype=torch.float64)
    w, mu = th.schur_horizon_solve(K, b, E, F, c)
    assert mu.shape == (B, 0, p)
    np.testing.assert_allclose(w[:, 0].numpy(), np.linalg.solve(
        K[:, 0].numpy(), b[:, 0].numpy()[..., None])[..., 0], atol=1e-12)
    C = torch.tensor(rng.normal(size=(B, 1, k, a)) * 0.1)
    Dh = rng.normal(size=(B, a, a))
    Dg = torch.tensor(Dh @ Dh.transpose(0, 2, 1) + 0.5 * np.eye(a))
    bg = torch.tensor(rng.normal(size=(B, a)))
    w, mu, g = th.schur_horizon_solve(K, b, E, F, c, C=C, Dg=Dg, bg=bg)
    for i in range(B):
        M = np.block([[K[i, 0].numpy(), C[i, 0].numpy()],
                      [C[i, 0].numpy().T, Dg[i].numpy()]])
        sol = np.linalg.solve(M, np.concatenate([b[i, 0].numpy(),
                                                 bg[i].numpy()]))
        np.testing.assert_allclose(w[i, 0].numpy(), sol[:k], atol=1e-12)
        np.testing.assert_allclose(g[i].numpy(), sol[k:], atol=1e-12)


def test_factor_rejects_an_unknown_route():
    K = torch.eye(4, dtype=torch.float64).expand(1, 2, 4, 4)
    with pytest.raises(ValueError, match="kkt_solver"):
        th.schur_horizon_factor(K, np.zeros((1, 4)), np.zeros((1, 4)),
                                kkt_solver="pallas")
