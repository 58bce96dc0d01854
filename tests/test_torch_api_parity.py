"""Parity of the port's smaller public entry points with their JAX twins,
on the CPU:

  * ``models.kite_ocp`` (the plain kite tracking OCP): dynamics, Lagrange
    and Mayer terms at random points in float64, and one ``transcribe`` +
    ``sqp_solve`` at B=2 per lane;
  * ``nlp.unbounded``, and ``sqp_solve`` / ``nlp_ip_solve`` without bounds
    equal to the same call with ``unbounded(nlp)``;
  * ``qp.infer_dims``, ``default_x0`` and ``default_y0``;
  * the lane-major LDL^T entry points ``ldlt_factor_lanes``,
    ``ldlt_solve_lanes``, ``ldlt_factor_solve_lanes`` and
    ``ldlt_inverse_lanes`` ((K, K, B) / (K, B), the batch last) against
    the JAX package's Pallas kernels in interpret mode at K=16, B=128
    float32, and against the port's batch-first calls bit for bit;
  * ``ops.structure.bbt_solve_dense`` (batch-first, packed right-hand
    side), the counterpart of the JAX package's ``bbt_solve_jnp``, on
    tests/test_bbt.py's inputs: the same (xb, xp).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_parity as tp  # noqa: E402
from _torch_parity import single_thread  # noqa: E402,F401
from polympc_tpu.basis import Chebyshev as JChebyshev  # noqa: E402
from polympc_tpu.basis import SegmentedBasis as JSegmentedBasis  # noqa: E402
from polympc_tpu.models import kite_ocp as j_kite_ocp  # noqa: E402
from polympc_tpu.nlp import SQPSettings as JSQPSettings  # noqa: E402
from polympc_tpu.nlp import sqp_solve as j_sqp  # noqa: E402
from polympc_tpu.nlp import unbounded as j_unbounded  # noqa: E402
from polympc_tpu.ocp import transcribe as j_transcribe  # noqa: E402
from polympc_tpu.ops import ldlt as jldlt  # noqa: E402
from polympc_tpu.ops import structure as jst  # noqa: E402
from polympc_tpu.qp import types as jqt  # noqa: E402
from polympc_tpu.qp.types import ADMMSettings as JADMMSettings  # noqa: E402
from polympc_torch.basis import Chebyshev, SegmentedBasis  # noqa: E402
from polympc_torch.models import kite_ocp  # noqa: E402
from polympc_torch.nlp import (  # noqa: E402
    IPNLPSettings, SQPSettings, nlp_ip_solve, sqp_solve, unbounded)
from polympc_torch.ocp import transcribe  # noqa: E402
from polympc_torch.ops import ldlt  # noqa: E402
from polympc_torch.ops import structure as tst  # noqa: E402
from polympc_torch.qp import infer_dims  # noqa: E402
from polympc_torch.qp import types as tqt  # noqa: E402
from polympc_torch.qp.types import ADMMSettings  # noqa: E402

KITE_D = [0.6, 0.3]


def test_kite_ocp_terms_match_jax():
    """Dynamics, Lagrange and Mayer of kite_ocp(q, r) at random points,
    float64, for the default and for other weights."""
    rng = np.random.default_rng(3)
    for q, r in ((1.0, 0.1), (2.5, 0.7)):
        j, t = j_kite_ocp(q, r), kite_ocp(q, r)
        assert (t.nx, t.nu, t.nd, t.np_) == (j.nx, j.nu, j.nd, j.np_)
        for _ in range(5):
            x, u, d = rng.normal(size=3), rng.normal(size=1), \
                rng.normal(size=2)
            p, tt = np.zeros(0), 0.3
            jx, ju, jp, jd = (jnp.asarray(a) for a in (x, u, p, d))
            tx, tu, tp_, td = (tp.t64(a) for a in (x, u, p, d))
            for name, want, got in (
                    ("dynamics", j.dynamics(jx, ju, jp, jd, tt),
                     t.dynamics(tx, tu, tp_, td, tt)),
                    ("lagrange", j.lagrange(jx, ju, jp, jd, tt),
                     t.lagrange(tx, tu, tp_, td, tt)),
                    ("mayer", j.mayer(jx, jp, jd), t.mayer(tx, tp_, td))):
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           rtol=1e-14, atol=1e-15,
                                           err_msg=name)


def test_kite_ocp_sqp_matches_jax_per_lane():
    """kite_ocp on Chebyshev(3) x 2 segments, tf=1, reference d, the exact
    Hessian SQP with LU-epoch QPs in float64 from two constant guesses:
    per-lane status and iterations equal, x within 1e-8."""
    jtr = j_transcribe(j_kite_ocp(), JSegmentedBasis(JChebyshev(3), 2))
    ttr = transcribe(kite_ocp(), SegmentedBasis(Chebyshev(3), 2))
    x0s = np.array([[0.5, 0.2, 0.0], [0.3, -0.4, 0.2]])
    qs = dict(rho=1.0, eps_abs=1e-8, eps_rel=1e-8, max_epochs=40,
              kkt_solver="lu")
    js = JSQPSettings(hessian="exact", max_iter=8, qp=JADMMSettings(**qs))
    ts = SQPSettings(hessian="exact", max_iter=8, qp=ADMMSettings(**qs))
    jprm = jtr.params(d=KITE_D, t0=0.0, tf=1.0)
    z0 = np.stack([np.asarray(jtr.initial_guess(x)) for x in x0s])
    want = jax.jit(jax.vmap(lambda z: j_sqp(jtr.nlp, z, p=jprm,
                                            settings=js)))(jnp.asarray(z0))
    got = sqp_solve(ttr.nlp, tp.t64(z0),
                    p=ttr.params(d=KITE_D, t0=0.0, tf=1.0, device="cpu"),
                    settings=ts)
    np.testing.assert_allclose(
        torch.stack([ttr.initial_guess(x, device="cpu")
                     for x in tp.t64(x0s)]).numpy(), z0, rtol=0, atol=0)
    np.testing.assert_array_equal(got.status.numpy(),
                                  np.asarray(want.status))
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(want.iters))
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=0,
                               atol=1e-8)


@pytest.mark.parametrize("ni", [0, 3])
def test_unbounded_matches_jax(ni):
    from polympc_tpu.nlp import NLP as JNLP
    from polympc_torch.nlp import NLP
    f = lambda x, p: x[0]
    g = lambda x, p: x[:ni]
    jn = JNLP(cost=f, n=5, ineq=g if ni else None, ni=ni)
    tn = NLP(cost=f, n=5, ineq=g if ni else None, ni=ni)
    for jd, td in ((jnp.float64, torch.float64), (jnp.float32,
                                                  torch.float32)):
        want, got = j_unbounded(jn, jd), unbounded(tn, td, device="cpu")
        for name in ("lbx", "ubx", "gl", "gu"):
            w, v = np.asarray(getattr(want, name)), getattr(got, name)
            assert v.dtype == td and v.device.type == "cpu"
            np.testing.assert_array_equal(v.numpy(), w, err_msg=name)


def test_solvers_without_bounds_take_unbounded():
    """sqp_solve and nlp_ip_solve with bounds=None equal the same call with
    unbounded(nlp), bit for bit (the inlined bounds they replaced)."""
    from polympc_torch.nlp import NLP
    nlp = NLP(cost=lambda x, p: (1.0 - x[:, 0]) ** 2
              + 100.0 * (x[:, 1] - x[:, 0] ** 2) ** 2, n=2)
    x0 = tp.t64([[-1.2, 1.0], [0.5, 0.5]])
    for solve, s in ((sqp_solve, SQPSettings(max_iter=5)),
                     (nlp_ip_solve, IPNLPSettings(max_iter=5))):
        a = solve(nlp, x0, settings=s)
        b = solve(nlp, x0, bounds=unbounded(nlp, device="cpu"), settings=s)
        assert torch.equal(a.x, b.x) and torch.equal(a.iters, b.iters)


def test_qp_helpers_match_jax():
    rng = np.random.default_rng(4)
    B, n, m = 3, 6, 4
    arrays = dict(H=rng.normal(size=(B, n, n)), h=rng.normal(size=(B, n)),
                  A=rng.normal(size=(B, m, n)), al=-np.ones((B, m)),
                  au=np.ones((B, m)), xl=-np.ones((B, n)),
                  xu=np.ones((B, n)))
    tq = tqt.QPData(**{k: tp.t64(v) for k, v in arrays.items()})
    for lane in range(B):
        jq = jqt.QPData(**{k: jnp.asarray(v[lane])
                           for k, v in arrays.items()})
        assert infer_dims(tq) == jqt.infer_dims(jq) == (n, m)
        np.testing.assert_array_equal(tqt.default_x0(tq)[lane].numpy(),
                                      np.asarray(jqt.default_x0(jq)))
        np.testing.assert_array_equal(tqt.default_y0(tq)[lane].numpy(),
                                      np.asarray(jqt.default_y0(jq)))
    assert tqt.default_x0(tq).shape == (B, n)
    assert tqt.default_y0(tq).shape == (B, m)


LANES_K, LANES_B = 16, 128


@pytest.fixture(scope="module")
def lanes_case():
    """(K, K, B) quasi-definite matrices [[H, A'], [A, -D]] (nz=10, m=6)
    and right-hand sides (K, B) in float32, and the JAX package's
    lane-major Pallas kernels on them in interpret mode."""
    rng = np.random.default_rng(12)
    nz, m = 10, LANES_K - 10
    G = rng.normal(size=(LANES_B, nz, nz))
    M = np.zeros((LANES_B, LANES_K, LANES_K))
    M[:, :nz, :nz] = G @ G.transpose(0, 2, 1) / nz + np.eye(nz)
    A = rng.normal(size=(LANES_B, m, nz))
    M[:, :nz, nz:] = A.transpose(0, 2, 1)
    M[:, nz:, :nz] = A
    M[:, nz:, nz:] = -np.eye(m) * rng.uniform(0.5, 2.0, (LANES_B, m, 1))
    M = np.moveaxis(M, 0, -1).astype(np.float32)              # (K, K, B)
    b = rng.normal(size=(LANES_K, LANES_B)).astype(np.float32)
    jM, jb = jnp.asarray(M), jnp.asarray(b)
    F, d = jldlt.ldlt_factor_lanes(jnp.array(M), interpret=True)
    x, F2, d2 = jldlt.ldlt_factor_solve_lanes(jnp.array(M), jb,
                                              interpret=True)
    return {"M": M, "b": b, "F": np.asarray(F), "d": np.asarray(d),
            "x": np.asarray(x), "F2": np.asarray(F2), "d2": np.asarray(d2),
            "xs": np.asarray(jldlt.ldlt_solve_lanes(F, d, jb,
                                                    interpret=True)),
            "inv": np.asarray(jldlt.ldlt_inverse_lanes(jM, interpret=True))}


def _upper(F):
    """The strict upper triangle of (K, K, B) factors (L^T; the rest is
    scratch that no caller reads)."""
    return np.triu(np.moveaxis(F, -1, 0), 1)


LANES_RTOL = 1e-5


def test_ldlt_lanes_match_jax(lanes_case):
    c = lanes_case
    M, b = torch.tensor(c["M"]), torch.tensor(c["b"])
    F, d = ldlt.ldlt_factor_lanes(M)
    assert F.shape == (LANES_K, LANES_K, LANES_B)
    assert d.shape == (LANES_K, LANES_B)
    np.testing.assert_allclose(_upper(F.numpy()), _upper(c["F"]),
                               rtol=LANES_RTOL, atol=LANES_RTOL)
    np.testing.assert_allclose(d.numpy(), c["d"], rtol=LANES_RTOL)
    x, F2, d2 = ldlt.ldlt_factor_solve_lanes(M, b)
    assert x.shape == (LANES_K, LANES_B)
    np.testing.assert_allclose(x.numpy(), c["x"], rtol=LANES_RTOL,
                               atol=LANES_RTOL)
    np.testing.assert_allclose(_upper(F2.numpy()), _upper(c["F2"]),
                               rtol=LANES_RTOL, atol=LANES_RTOL)
    np.testing.assert_allclose(d2.numpy(), c["d2"], rtol=LANES_RTOL)
    xs = ldlt.ldlt_solve_lanes(torch.tensor(c["F"]), torch.tensor(c["d"]),
                               b)
    np.testing.assert_allclose(xs.numpy(), c["xs"], rtol=LANES_RTOL,
                               atol=LANES_RTOL)
    inv = ldlt.ldlt_inverse_lanes(M)
    assert inv.shape == (LANES_K, LANES_K, LANES_B)
    np.testing.assert_allclose(inv.numpy(), c["inv"], rtol=LANES_RTOL,
                               atol=LANES_RTOL)


def test_ldlt_lanes_equal_batch_first_calls(lanes_case):
    """Each lane-major entry point is its batch-first twin through a
    movedim: equal bit for bit."""
    M, b = torch.tensor(lanes_case["M"]), torch.tensor(lanes_case["b"])
    Mb, bb = M.movedim(-1, 0), b.movedim(-1, 0)
    F, d = ldlt.ldlt_factor(Mb)
    got = ldlt.ldlt_factor_lanes(M)
    assert torch.equal(got[0], F.movedim(0, -1))
    assert torch.equal(got[1], d.movedim(0, -1))
    x, F2, d2 = ldlt.ldlt_factor_solve(Mb, bb)
    for g, w in zip(ldlt.ldlt_factor_solve_lanes(M, b), (x, F2, d2)):
        assert torch.equal(g, w.movedim(0, -1))
    assert torch.equal(ldlt.ldlt_solve_lanes(got[0], got[1], b),
                       ldlt.ldlt_solve(F, d, bb).movedim(0, -1))
    assert torch.equal(ldlt.ldlt_inverse_lanes(M),
                       ldlt.ldlt_inverse(Mb).movedim(0, -1))


def _bbt_case(kind, segments):
    """tests/test_bbt.py's KKT of the kite or the parking transcription
    and its JAX block storage."""
    import importlib
    tb = importlib.import_module("test_bbt")
    tr = tb._kite_tr(segments) if kind == "kite" else tb._parking_tr(
        segments)
    ocp = tr.ocp
    dims = (tr.N, ocp.nx, ocp.nu, ocp.ng, ocp.np_, ocp.ntg, tr.mesh.order,
            tr.mesh.num_segments)
    st = jst.bbt_structure(*dims)
    K, b = tb._kkt_of(tr)
    return st, tst.bbt_structure(*dims), jst.gather_blocks(K, b, st)


@pytest.mark.parametrize("kind,segments", [("kite", 8), ("parking", 4)])
def test_bbt_solve_dense_matches_bbt_solve_jnp(kind, segments):
    """bbt_solve_dense on the JAX gather's blocks (Oh moved to the port's
    slots 1..S-1, C transposed, b packed as [bb; bp]) gives
    bbt_solve_jnp's (xb, xp)."""
    st, tst_st, (Td, Oh, C, Dp, bb, bp) = _bbt_case(kind, segments)
    xb, xp = jst.bbt_solve_jnp(Td, Oh, C, Dp, bb, bp, st)
    S, k, a, nx = st.S, st.k, st.a, st.nx
    Oh_t = np.zeros((S, k, nx))
    Oh_t[1:] = np.asarray(Oh)
    rhs = np.concatenate([np.asarray(bb).reshape(-1), np.asarray(bp)])
    assert (tst_st.perm, tst_st.border, tst_st.bx) == (st.perm, st.border,
                                                      st.bx)
    got = tst.bbt_solve_dense(
        tp.t64(Td)[None], tp.t64(Oh_t)[None],
        tp.t64(np.swapaxes(np.asarray(C), 1, 2))[None], tp.t64(Dp)[None],
        tp.t64(rhs)[None], tst_st)[0].numpy()
    np.testing.assert_allclose(got[:S * k].reshape(S, k), np.asarray(xb),
                               rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(got[S * k:], np.asarray(xp), rtol=1e-10,
                               atol=1e-10)
    assert got.shape == (S * k + a,)

