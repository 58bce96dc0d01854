"""The frozen operation and byte counts against counts made by hand at
small shapes."""
import pytest

from port_bench.pb import roofline as rf


def test_factor_and_solve_counts():
    # K=2: one pivot with a trailing order 1: 1*2 + 1 = 3
    assert rf.flops_factor(2) == 3
    # K=3: trailing orders 1 and 2: (2 + 1) + (6 + 2) = 11
    assert rf.flops_factor(3) == 11
    # forward and backward sweeps: 2 K (K-1) multiply-adds, K divisions
    assert rf.flops_solve(3) == 2 * 3 * 2 + 3
    assert rf.flops_solve(4, nrhs=2) == 2 * (2 * 4 * 3 + 4)


def test_bbt_counts_one_block_without_border():
    st = rf.BBT(S=1, k=2, nx=1, a=0)
    # one block: its factor (3) and a solve with nx + a = 1 right side (6)
    assert rf.flops_bbt_factor(st) == 3 + 6
    assert rf.flops_bbt_solve(st) == 6
    # 4 bytes x (the block, its coupling, 11 vectors of S k + a)
    assert rf.bbt_bytes(st, 11) == 4 * (2 * (2 + 1) + 11 * 2)


def test_bbt_counts_two_blocks_with_border():
    st = rf.BBT(S=2, k=2, nx=1, a=1)
    per_block = rf.flops_factor(2) + rf.flops_solve(2, 2) + 2 * 1 * 2
    coupling = 2 * (2 * 1 + 1 * 2 * 1 + 2 * 2 * 1)
    assert rf.flops_bbt_factor(st) == 2 * 1 + 2 * per_block + coupling
    assert rf.flops_bbt_solve(st) == 2 * 6 + 4 * 2 + 4 * 2 * 2 + 2
    assert rf.bbt_bytes(st, 2) == 4 * (2 * 2 * 4 + 1 + 2 * 5)


def test_epoch_bound_is_the_larger_of_the_two():
    st = rf.BBT(S=2, k=72, nx=5, a=0)
    t, by = rf.bound_bbt_epoch(st, 512, 50)
    flops = 512 * (rf.flops_bbt_factor(st)
                   + 50 * (rf.flops_bbt_solve(st) + 15 * 144))
    assert t == pytest.approx(max(flops / 67e12,
                                  512 * rf.bbt_bytes(st, 11) / 3.35e12))
    assert by == "operations"
    # the kite epoch at B=512: 0.0124 ms (PERF.md's kernel table)
    assert t * 1e3 == pytest.approx(0.0124, rel=0.02)


def test_newton_solve_bound_counts_each_piece():
    K, B, ir = 4, 3, 2
    flops = rf.flops_factor(K) + rf.flops_solve(K) \
        + ir * (2 * K * K + rf.flops_solve(K))
    words = (2 * K * K + 3 * K) + ir * 2 * (K * K + 3 * K)
    assert rf.bound_newton_solve(B, K, ir)[0] == pytest.approx(
        max(B * flops / 67e12, B * 4 * words / 3.35e12))
    # the certify's factor-solve at B=512, K=132: 0.0215 ms (bytes)
    t, by = rf.bound_ldlt("factor_solve", 512, 132)
    assert (t * 1e3, by) == (pytest.approx(0.0215, rel=0.01), "bytes")
