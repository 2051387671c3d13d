"""Smoke tests for the benchmark/probe CLIs (CPU, tiny params).

The tools are the round drivers' measurement surface
(bench.py / tools/*.py); these guard their JSON contracts and the
errors==0 invariant so refactors can't silently rot them.
"""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(cmd, env_extra, timeout=420):
    env = dict(
        os.environ,
        PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
        **env_extra,
    )
    out = subprocess.run(
        [sys.executable] + cmd, cwd=REPO, env=env, timeout=timeout,
        capture_output=True, text=True,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    lines = [ln for ln in out.stdout.splitlines()
             if ln.startswith("{")]
    assert lines, out.stdout + out.stderr
    return [json.loads(ln) for ln in lines]


#: bench.py's JSON contract: one line with metric/value/unit/
#: vs_baseline, the run's shape and the device it ran on.
BENCH_REQUIRED = {"metric", "value", "unit", "vs_baseline", "batch",
                  "iters", "seconds", "decrypt_errors", "params",
                  "platform", "device_kind", "device_count"}
WIDTH_REQUIRED = {"case", "op", "errors", "gates_per_pass", "batch",
                  "width", "seconds_warm", "bootstraps_per_sec",
                  "params", "device"}
EXPR_REQUIRED = {"metric", "value", "unit", "expr", "errors", "batch",
                 "width", "dp", "gates_per_pass", "seconds_warm",
                 "bootstraps_per_sec", "params", "device"}


@pytest.mark.slow
def test_bench_smoke():
    # BENCH_FORCE_CPU: bench.py refuses to run without a GPU otherwise
    (rec,) = _run(["bench.py"],
                  {"BENCH_PARAMS": "tiny", "BENCH_ITERS": "2",
                   "BENCH_FORCE_CPU": "1"})
    assert rec["metric"] == "gate_bootstraps_per_sec_per_chip"
    assert rec["unit"] == "bootstraps/s"
    assert rec["decrypt_errors"] == 0
    assert rec["value"] > 0 and rec["vs_baseline"] > 0
    missing = BENCH_REQUIRED - set(rec)
    assert not missing, f"bench.py contract fields missing: {missing}"


@pytest.mark.slow
def test_width_bench_smoke():
    (rec,) = _run(["tools/width_bench.py"],
                  {"WB_FORCE_CPU": "1", "WB_PARAMS": "test_tiny",
                   "WB_CASES": "mul32"})
    assert rec["case"] == "mul32" and rec["errors"] == 0
    assert rec["gates_per_pass"] > 0
    missing = WIDTH_REQUIRED - set(rec)
    assert not missing, f"width_bench contract fields missing: {missing}"


@pytest.mark.slow
def test_expr_bench_smoke_both_exprs():
    (rec,) = _run(["tools/expr_bench.py"],
                  {"EB_FORCE_CPU": "1", "EB_PARAMS": "test_tiny",
                   "EB_BATCH": "8", "EB_WIDTH": "8", "EB_DP": "8"})
    assert rec["expr"] == "A+B-C" and rec["errors"] == 0
    missing = EXPR_REQUIRED - set(rec)
    assert not missing, f"expr_bench contract fields missing: {missing}"
    (rec,) = _run(["tools/expr_bench.py"],
                  {"EB_FORCE_CPU": "1", "EB_PARAMS": "test_tiny",
                   "EB_BATCH": "8", "EB_WIDTH": "8", "EB_DP": "8",
                   "EB_EXPR": "add_mul"})
    assert rec["expr"] == "A-B*C" and rec["errors"] == 0
    # the chained double multiply (width doubles twice) is the
    # reference Fig.7 A*B*C case — the heaviest expression shape
    (rec,) = _run(["tools/expr_bench.py"],
                  {"EB_FORCE_CPU": "1", "EB_PARAMS": "test_tiny",
                   "EB_BATCH": "8", "EB_WIDTH": "8", "EB_DP": "8",
                   "EB_EXPR": "mul_mul"})
    assert rec["expr"] == "A*B*C" and rec["errors"] == 0


@pytest.mark.slow
def test_scaling_bench_sp_smoke():
    recs = _run(["tools/scaling_bench.py"],
                {"SB_FORCE_CPU": "1", "SB_PARAMS": "test_tiny",
                 "SB_BATCH_PER_CHIP": "8", "SB_ITERS": "1",
                 "SB_SP": "4"})
    assert recs[-1]["metric"] == "scaling_efficiency"
    assert all(r.get("errors", 0) == 0 for r in recs[:-1])
    assert all(r.get("sp") == 4 for r in recs[:-1])


@pytest.mark.slow
def test_scaling_bench_smoke():
    recs = _run(["tools/scaling_bench.py"],
                {"SB_FORCE_CPU": "1", "SB_PARAMS": "test_tiny",
                 "SB_BATCH_PER_CHIP": "8", "SB_ITERS": "1"})
    assert recs[-1]["metric"] == "scaling_efficiency"
    assert all(r.get("errors", 0) == 0 for r in recs[:-1])


def test_keyplane_bench_smoke():
    """Key-plane benchmark JSON contract at tiny params (the lambda=110
    head-to-head runs in rounds; this guards the harness)."""
    (rec,) = _run(["tools/keyplane_bench.py"],
                  {"KB_PARAMS": "test_tiny", "KB_CLIENTS": "1",
                   "KB_ITERS": "1"})
    assert rec["probe"] == "keyplane_fig9_fig10"
    one = rec["per_clients"]["1"]
    assert one["total_s"] > 0 and len(one["client_exchange_s"]) == 1


@pytest.mark.slow
def test_e2e_bench_smoke():
    """The full-system E2E harness (six OS processes, every BASELINE
    phase spanned) runs at tiny params on CPU with decrypt_errors=0
    and carries all the phase rows the round artifact needs."""
    (rec,) = _run(["tools/e2e_bench.py"],
                  {"E2E_PARAMS": "test_tiny", "E2E_FORCE_CPU": "1",
                   "E2E_WIDTH": "8", "E2E_BATCH": "2",
                   "E2E_TIMEOUT": "300"}, timeout=600)
    assert rec["probe"] == "e2e_lambda110"
    assert rec["decrypt_errors"] == 0
    rows = rec["baseline_rows"]
    for key in ("key_exchange", "user_input_processing",
                "data_request_per_operand",
                "compute_total_warm[AB+C-]",
                "compute_total_warm[AB*C-]"):
        assert key in rows and rows[key]["speedup"] > 0, key
    names = {s["name"] for s in rec["cloud_spans"]}
    assert {"job_receive", "data_request", "compute_chain",
            "answer_ship"} <= names
