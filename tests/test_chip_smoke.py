"""chip_smoke.py's CPU-testable parts: the oracle comparison, the closing
line, the refusal to run without a GPU, and the four-card sweep
comparison rehearsed on virtual CPU devices."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402


@pytest.mark.parametrize("mode", ["fov", "connectivity"])
def test_oracle_comparison_on_cpu(mode):
    """Phase f at 8 lanes with two CPU devices standing in for GPU and
    CPU: every certified lane meets the certificate against the native
    oracle, the raw path stays usable, and identical programs agree."""
    cpu = jax.devices("cpu")
    out = cs.compare_solvers(jax, mode, 8, devices=[cpu[0], cpu[1]])
    assert out["ok"], out
    assert out["oracle_optimal"] == 8
    assert out["cpu_raw_usable_rate"] >= cs.FOV_USABLE_MIN
    assert out["cpu_certified_fail_certificate"] == 0
    assert out["cpu_certified_meet_certificate"] >= 7
    assert out["cpu_cert_max_dev"] is not None
    # same backend, same program: the two results are identical
    assert out["gpu_cpu_raw_obj_gap_max"] == 0.0
    assert out["gpu_cpu_cert_max_control_gap"] == 0.0


def test_oracle_comparison_flags_a_wrong_lane():
    """The two-part certificate rejects a lane that is neither close in
    control nor e-equal-optimal, and accepts the oracle's own solution."""
    rng = np.random.default_rng(0)
    n, m, B = 4, 3, 2
    P = np.eye(n)
    q = rng.normal(size=(B, n))
    A = np.broadcast_to(np.eye(m, n), (B, m, n)).copy()
    lb, ub = -np.ones((B, m)), np.ones((B, m))
    x_ref = np.clip(-q, -1, 1)
    z = x_ref.copy()
    z[1, 0] += 0.5
    U = np.eye(n)
    r = cs.oracle_comparison(P, q, A, lb, ub, z, x_ref, U, n, 1e20)
    assert r["certificate"].tolist() == [True, False]
    assert r["dev"][0] == 0.0 and r["dev"][1] == pytest.approx(0.5)


_GPU = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}


@pytest.mark.parametrize("case", ["ok", "failed_phase", "cpu_device", "mixed_devices"])
def test_last_line(case):
    results = [{"phase": "a", "ok": True, "device": dict(_GPU)},
               {"phase": "b", "ok": True, "device": dict(_GPU)}]
    if case == "ok":
        line = cs.last_line(results)
        assert line == ('{"ok": true, "device": {"platform": "gpu", '
                        '"kind": "NVIDIA H100 80GB HBM3", "count": 1}}')
        assert json.loads(line)["device"]["count"] == 1
        return
    if case == "failed_phase":
        results[1]["ok"] = False
    elif case == "cpu_device":
        for r in results:
            r["device"] = {"platform": "cpu", "kind": "cpu", "count": 1}
    else:
        results[1]["device"] = {**_GPU, "count": 4}
    with pytest.raises(ValueError):
        cs.last_line(results)


@pytest.mark.parametrize("how", ["no_card", "child_on_cpu", "script_alone"])
def test_exits_nonzero_without_gpu(how, tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    script = REPO / "chip_smoke.py"
    if how == "script_alone":
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script = tmp_path / "chip_smoke.py"
    argv = [sys.executable, str(script)]
    if how == "child_on_cpu":
        argv += ["--phase", "a_fov_raw"]
    p = subprocess.run(argv, cwd=script.parent, env=env, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0
    assert '"ok": true' not in p.stdout
    assert cs.RESULT_TAG not in p.stdout


def test_four_card_sweep_comparison_on_virtual_devices():
    """The --four-cards comparison on 4 virtual CPU devices: the sharded
    rollout spans all 4, and every seed's first step matches the 1-device
    rollout (a seed simulated against another seed's state would not)."""
    r = cs.sweep_comparison(jax, 4, seeds=8, sim_runtime=0.3)
    assert r["sharded_over_devices"] == 4
    assert r["finite"]
    assert r["step1_max_gap_m"] <= cs.STEP1_TOL
    assert len(r["success"]) == len(r["one_card_success"]) == 8


@pytest.mark.gpu
def test_gpu_matches_cpu_and_oracle(gpu):
    """Phase f at 32 lanes on the card: GPU against the oracle and the CPU."""
    out = cs.compare_solvers(jax, "fov", 32, devices=[gpu, jax.devices("cpu")[0]])
    assert out["ok"], out
