"""A run's ``correct`` comes out false where the timed path is broken
underneath or the control stands in the program's place, and true where it
is sound.

Each case drives the rest of a run on the CPU (``run_cell`` past the look
for a card) at a size a test can hold, once for each fault the cell can
have: a step that returns its state unchanged, half of a batch left out
(its lanes filled with the other half's answers), and an answer altered
where it is produced (the SQP's point, and the certified point).  Two more
leave the reported violation honest: the SQP's multipliers halved on a
point it still reports SOLVED, and the program handed its model with one
cost weight doubled, so that it solves, and reports the objective of, a
problem other than the configuration's.  The cells run on one card, so no
exchange between cards can be left out."""
import contextlib
import copy

import pytest
import torch

import polympc_torch.parallel.batch as batch_mod
import port_bench.pb.certify as certify_mod
from port_bench.pb.runner import run_cell
from port_bench.pb.spec import Cell

CELLS = {"kite_b4096": ({"batch": 6, "sample_lanes": 6, "audit_batches": 1},
                        0.0),
         "race_car_loop_b1": ({"warmup_steps": 1}, 2.0)}
BATCH = ("kite_b4096",)
# the cost weight each configuration's fault doubles: its path in cfg
WEIGHT = {"kite_nmpf": ("model", "W"),
          "race_car": ("model", "weights", "q_vx")}


@pytest.fixture(autouse=True, scope="module")
def single_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(cell, control=False):
    overrides, seconds = CELLS[cell]
    result, _ = run_cell(cell, 2 ** 31 + 11, seconds, False, device="cpu",
                         traffic_overrides=overrides, control=control)
    return result


def _unchanged(real):
    def fake(nlp, x0, p=None, bounds=None, lam0=None, lam_box0=None,
             settings=None):
        sol = real(nlp, x0, p=p, bounds=bounds, lam0=lam0,
                   lam_box0=lam_box0, settings=settings)
        return sol._replace(
            x=x0.clone(),
            lam=torch.zeros_like(sol.lam) if lam0 is None else lam0.clone(),
            lam_box=torch.zeros_like(sol.lam_box) if lam_box0 is None
            else lam_box0.clone())
    return fake


def _half_left_out(real):
    def fake(nlp, x0, p=None, bounds=None, lam0=None, lam_box0=None,
             settings=None):
        h = (x0.shape[0] + 1) // 2
        cut = lambda t: None if t is None else t[:h]
        sol = real(nlp, x0[:h], p=p,
                   bounds=bounds._replace(lbx=bounds.lbx[:h],
                                          ubx=bounds.ubx[:h]),
                   lam0=cut(lam0), lam_box0=cut(lam_box0),
                   settings=settings)
        rep = lambda t: torch.cat([t, t])[:x0.shape[0]]
        return type(sol)(*(None if t is None else rep(t) for t in sol))
    return fake


def _sqp_altered(real):
    def fake(*args, **kwargs):
        sol = real(*args, **kwargs)
        x = sol.x.clone()
        x[:, 7] += 0.05
        return sol._replace(x=x)
    return fake


def _certified_altered(real):
    def fake(*args, **kwargs):
        out = real(*args, **kwargs)
        z = out[0].clone()
        z[:, 7] += 1e-4
        return (z,) + tuple(out[1:])
    return fake


def _multipliers_altered(real):
    def fake(*args, **kwargs):
        sol = real(*args, **kwargs)
        return sol._replace(lam=0.5 * sol.lam)
    return fake


def _weight_altered(real):
    def fake(cell):
        mod = real(cell)
        build = mod.build

        def altered(cfg, device):
            cfg = copy.deepcopy(cfg)
            *path, key = WEIGHT[cell.entry["config"]]
            d = cfg
            for k in path:
                d = d[k]
            d[key] *= 2.0
            return build(cfg, device)
        mod.build = altered
        return mod
    return fake


FAULTS = {"unchanged": (batch_mod, "sqp_solve", _unchanged),
          "half_left_out": (batch_mod, "sqp_solve", _half_left_out),
          "sqp_altered": (batch_mod, "sqp_solve", _sqp_altered),
          "certified_altered": (certify_mod, "refine_solution",
                                _certified_altered),
          "multipliers_altered": (batch_mod, "sqp_solve",
                                  _multipliers_altered),
          "weight_altered": (Cell, "loader", _weight_altered)}
LOOP_FAULTS = ("unchanged", "sqp_altered", "multipliers_altered",
               "weight_altered")
BATCH_FAULTS = ("unchanged", "half_left_out", "sqp_altered",
                "certified_altered", "weight_altered")
CASES = [(c, f) for c in CELLS for f in FAULTS
         if f in (BATCH_FAULTS if c in BATCH else LOOP_FAULTS)]


@contextlib.contextmanager
def _planted(fault, monkeypatch):
    mod, attr, make = FAULTS[fault]
    monkeypatch.setattr(mod, attr, make(getattr(mod, attr)))
    yield


@pytest.mark.parametrize("cell", list(CELLS))
def test_a_sound_run_is_correct(cell):
    r = _run(cell)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0


@pytest.mark.parametrize("cell", list(CELLS))
def test_the_control_is_not_correct(cell):
    r = _run(cell, control=True)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    with _planted(fault, monkeypatch):
        r = _run(cell)
    assert not r["correct"], r["checks"]
