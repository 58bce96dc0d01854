"""Shared set-up of the JAX-vs-PyTorch parity tests (tests/test_torch_*.py).

The same problems are built in both packages: bench.py's augmented kite, and
the minimum-time parking OCP with a parameter and a node inequality (its
KKT has a border).  Inputs are made with numpy from a seed and handed to
both sides; the port receives them through ``polympc_torch.utils.convert``.
"""
import contextlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from polympc_tpu.basis import Chebyshev as JChebyshev
from polympc_tpu.basis import SegmentedBasis as JSegmentedBasis
from polympc_tpu.control.nmpf import augment_ocp as j_augment_ocp
from polympc_tpu.models import kite_dynamics as j_kite_dynamics
from polympc_tpu.models import kite_output as j_kite_output
from polympc_tpu.models import kite_path as j_kite_path
from polympc_tpu.models import parking_ocp as j_parking_ocp
from polympc_tpu.nlp import SQPSettings as JSQPSettings
from polympc_tpu.ocp import ocp_bounds as j_ocp_bounds
from polympc_tpu.ocp import transcribe as j_transcribe
from polympc_tpu.qp.types import ADMMSettings as JADMMSettings

from polympc_torch import headline
from polympc_torch.basis import Chebyshev, SegmentedBasis
from polympc_torch.models import parking_ocp
from polympc_torch.ocp import transcribe

KITE_XL = [0.0, -np.pi / 2, -np.pi, -100.0, -100.0]
KITE_XU = [np.pi / 2, np.pi / 2, np.pi, 100.0, 100.0]


def jax_kite(dtype=jnp.float64, kkt_solver="pallas"):
    """bench.py's problem in the JAX package: (tr, bounds, prm, settings)."""
    ocp = j_augment_ocp(lambda x, u: j_kite_dynamics(x, u), j_kite_output,
                        j_kite_path, nx=3, nu=1, ny=2)
    tr = j_transcribe(ocp, JSegmentedBasis(JChebyshev(5), 2))
    prm = tr.params(d=[0.05], t0=0.0, tf=2.0, dtype=dtype)
    bounds = j_ocp_bounds(tr, ul=[-5.0, -10.0], uu=[5.0, 10.0], xl=KITE_XL,
                          xu=KITE_XU, dtype=dtype)
    settings = JSQPSettings(
        hessian="exact", max_iter=9, reg="mirror",
        eps_prim=1e-3, eps_dual=1e-3, eps_viol=1e-3, eps_stat=1e-2,
        qp=JADMMSettings(rho=1.0, eps_abs=1e-4, eps_rel=1e-4,
                         max_epochs=3, check_every=50, equil_iters=0,
                         kkt_solver=kkt_solver, structure=tr.bbt_structure(),
                         polish=False))
    return tr, bounds, prm, settings


def torch_kite(dtype=torch.float64):
    """The same problem in the port."""
    return headline.kite_problem("cpu", dtype)


def jax_parking():
    return j_transcribe(j_parking_ocp(nonlinear_constraint=True),
                        JSegmentedBasis(JChebyshev(5), 2))


def torch_parking_ocp():
    """The port's parking_ocp(nonlinear_constraint=True): time-scaled
    kinematic car (p0 scales the dynamics, Mayer = p0) with the node
    inequality g0 = u0^2 cos(u1)."""
    return parking_ocp(nonlinear_constraint=True)


def torch_parking():
    """The parking OCP transcribed on Chebyshev(5) x 2 segments."""
    return transcribe(torch_parking_ocp(), SegmentedBasis(Chebyshev(5), 2))


def lane_points(tr, B, seed, scale=0.3):
    """Random decision vectors and multipliers (B, n), (B, m) in numpy."""
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(B, tr.nlp.n)) * scale
    lam = rng.normal(size=(B, tr.nlp.m))
    return z, lam


def t64(a):
    return torch.tensor(np.array(a, np.float64))


@contextlib.contextmanager
def one_thread():
    """Run a block with one intra-op CPU thread.  In CPU builds of PyTorch
    that factor with oneMKL, a batched LU of matrices above about 150 rows
    (``torch.linalg.lu_factor``, ``solve``) can hang when more than one
    thread works on it: the race car's LU epoch (K=165) and the kite's
    polish system (K=209) are such matrices."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def single_thread():
    """A module's tests and fixtures on one intra-op thread (autouse in the
    modules that import it): the suite's workers share the CPU, where more
    threads per worker only contend (the CPU race-car harness takes 2.4x
    longer on two threads beside five other busy processes); see also
    :func:`one_thread`."""
    with one_thread():
        yield
