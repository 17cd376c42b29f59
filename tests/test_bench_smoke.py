"""Compile-and-run smoke test of the EXACT bench.py entry paths.

A bench default that has never been executed can crash at compile time
on the accelerator. This test compiles and runs every bench mode at tiny
batch on the CPU mesh so that class of regression cannot ship silently —
if bench.build() stops compiling, CI goes red.
"""
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import bench  # noqa: E402


def _run(mode, batch=8, accuracy=""):
    control_batch, impc_iter = bench.build(mode, batch, accuracy)
    coeffs, success, certified = control_batch()
    coeffs = np.asarray(coeffs)
    assert coeffs.shape[0] == batch
    assert np.all(np.isfinite(coeffs))
    assert impc_iter >= 1
    return np.asarray(success), np.asarray(certified)


def test_bench_fov_path_compiles_and_runs():
    # the raw production path (f32 Mehrotra IPM): interior iterates are
    # feasible by construction. Bar derived from the SAME sampling
    # distribution bench.py uses (seed 0): the H100 measures 0.9974
    # usable on all 8192 lanes (PERF.md); a 64-lane slice at >= 0.92
    # (>= 59/64) trips on any real regression of that rate while
    # tolerating ~2-sigma sampling noise.
    success, certified = _run("fov", batch=64)
    assert success.mean() >= 0.92
    # the raw path must NEVER claim the accuracy certificate
    assert not certified.any()


def test_bench_fov_admm_path_compiles_and_runs(monkeypatch):
    # the structured-ADMM path stays available behind BENCH_SOLVER=admm
    monkeypatch.setenv("BENCH_SOLVER", "admm")
    success, certified = _run("fov")
    assert success.mean() >= 0.75
    assert not certified.any()


def test_bench_connectivity_path_compiles_and_runs():
    success, _ = _run("connectivity")
    assert success.mean() > 0.9


def test_bench_fov_polish_path_compiles_and_runs():
    # conftest enables x64 globally, matching bench.py's polish config.
    # The polish can only certify lanes whose ADMM entry found the right
    # active set (6/8 on this slice); the IPM owns the 100% bar.
    success, certified = _run("fov", accuracy="polish")
    assert success.mean() >= 0.75
    # certified lanes are a subset of successful ones
    assert (certified <= success).all()


def test_bench_fov_ipm_path_compiles_and_runs():
    # the certified fov path: EVERY feasible lane must be usable
    success, _ = _run("fov", accuracy="ipm")
    assert success.mean() == 1.0


def test_bench_fov_certified_path_compiles_and_runs():
    # the shipping certified pipeline (HYBRID_PROD): f32-only iter 0 +
    # hybrid iter 1; flown curves carry the certificate at the
    # calibrated-bar rate (0.988 of 8192 lanes on the H100, PERF.md —
    # a small slice must still certify most lanes)
    success, certified = _run("fov", batch=16, accuracy="certified")
    assert success.mean() >= 0.9
    assert certified.mean() >= 0.8
    assert (certified <= success).all()


def test_bench_connectivity_ipm_path_compiles_and_runs():
    success, _ = _run("connectivity", accuracy="ipm")
    assert success.mean() == 1.0


def test_bench_connectivity_certified_path_compiles_and_runs():
    # the certified pipeline generalizes across variants: on the cheap
    # connectivity family it certifies ~1.0 (0.99994 of 32,768 lanes on
    # the H100, PERF.md)
    success, certified = _run("connectivity", batch=16, accuracy="certified")
    assert success.mean() == 1.0
    assert certified.mean() >= 0.9
    assert (certified <= success).all()
