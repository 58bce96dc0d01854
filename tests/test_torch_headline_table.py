"""The port's headline table (polympc_torch.headline_table) on the CPU at
tiny batches, and the committed record of the JAX package it is held
against on the card (tests/data/headline_jax_cpu.npz):

  * each of the three workloads runs end to end through the plain versions,
    returns the harness's keys, names its device and launches no kernel;
  * its inputs are the harness's: the spline lanes and the race car's
    jittered states are the first rows of the record's, and the spline
    lanes solve as the JAX package's did;
  * on "cuda" a missing card raises;
  * the record holds what chip_smoke.py compares, at the harness's widths.
"""
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from _torch_parity import single_thread  # noqa: E402,F401
from polympc_torch import headline_table as ht  # noqa: E402
from polympc_torch.ops import _build  # noqa: E402
from polympc_torch.utils import status as st  # noqa: E402

RECORD = Path(__file__).resolve().parent / "data" / "headline_jax_cpu.npz"

COMMON = {"workload", "latency_ms_mean", "latency_ms_max", "batch",
          "batch_solved", "throughput_us_per_solve", "solves_per_s",
          "device"}


@pytest.fixture(scope="module")
def record():
    return dict(np.load(RECORD))


def test_record_holds_the_harness_widths(record):
    assert RECORD.stat().st_size < 1024 * 1024
    assert record["spline_status"].shape == (4096,)
    assert str(record["spline_kkt_solver"]) in ("pallas", "lu")
    assert record["frame_s"].shape == record["frame_s_true"].shape == (4096,)
    assert record["race_x0s"].shape == (512, 6)
    for k in ("race_residual", "race_certified", "race_status",
              "race_iters"):
        assert record[k].shape == (512,)
    np.testing.assert_array_equal(
        record["race_certified"],
        (record["race_status"] == st.SOLVED)
        & (record["race_residual"] <= ht.KKT_TOL))
    assert record["race_certified"].sum() >= 512 - 40
    np.testing.assert_array_equal(record["race_x0s"], ht.race_car_x0s(512))
    _, _, (_, _, s_b) = ht.frame_batch(4096, device="cpu")
    np.testing.assert_array_equal(record["frame_s_true"], s_b)


def test_spline_qp_on_cpu(record):
    _build.reset_launches()
    res, lanes = ht.spline_qp("cpu", batch=16, reps=1, batch_reps=1)
    assert sum(_build.LAUNCHES.values()) == 0
    assert COMMON | {"n", "m"} <= set(res) and res["device"] == "cpu"
    assert (res["n"], res["m"], res["batch"]) == (32, 15, 16)
    # float32 on both sides: the same lanes solve as in the JAX record
    np.testing.assert_array_equal(lanes["status"],
                                  record["spline_status"][:16])
    assert res["batch_solved"] == int((lanes["status"] == st.SOLVED).sum())


def test_frame_transform_on_cpu(record):
    res, lanes = ht.frame_transform("cpu", batch=32, reps=1, batch_reps=1)
    assert COMMON | {"batch_max_s_err"} <= set(res)
    assert res["device"] == "cpu" and res["batch_solved"] == 32
    assert res["batch_max_s_err"] < 1e-4 and lanes["s"].shape == (32,)


def test_race_car_on_cpu(record):
    _build.reset_launches()
    res, lanes = ht.race_car("cpu", batch=2, reps=1, batch_reps=1)
    assert sum(_build.LAUNCHES.values()) == 0
    assert COMMON | {"n", "m", "warm_iters", "batch_certified_1e-6",
                     "kkt_tol", "certified_kkt_max",
                     "certified_solves_per_s"} <= set(res)
    assert (res["n"], res["m"], res["device"]) == (99, 66, "cpu")
    # float32 SQP iteration counts are chaotic across summation orders:
    # the warm re-solve converges, in about the JAX package's count (5)
    assert 1 <= res["warm_iters"] <= 2 * int(record["race_warm_iters"])
    assert res["batch_certified_1e-6"] == int(lanes["certified"].sum())
    for k in ("residual", "certified", "status", "iters"):
        assert lanes[k].shape == (2,)


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for fn in (ht.spline_qp, ht.frame_transform, ht.race_car):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            fn("cuda", batch=2, reps=1, batch_reps=1)
