"""``run.py`` exits non-zero and prints no result where it cannot run:
no card, a checkout without the port, an unknown cell; and on a card,
one short run prints the contract's last line."""

import json
import shutil
import subprocess
import sys

import pytest
from conftest import CHECKOUT, need_card

RUN = ["portbench/run.py", "--workload", "vol256.separable", "--seed",
       "3000000017", "--seconds", "1", "--trace", "0"]


def run(cwd, args=RUN, env=None):
    return subprocess.run([sys.executable, *args], cwd=cwd,
                          capture_output=True, text=True, timeout=600,
                          env=env)


def bench_only(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files."""
    shutil.copy(CHECKOUT / "BENCHMARK.json", tmp_path)
    shutil.copytree(CHECKOUT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return tmp_path


def test_no_card_exits_nonzero_without_a_result():
    import os

    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = run(CHECKOUT, env=env)
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "portbench:" in proc.stderr


def test_unknown_workload_exits_nonzero():
    args = list(RUN)
    args[2] = "no.such.cell"
    proc = run(CHECKOUT, args)
    assert proc.returncode != 0 and proc.stdout == ""


def test_benchmark_files_alone_exit_nonzero(tmp_path):
    proc = run(bench_only(tmp_path))
    assert proc.returncode != 0 and proc.stdout == ""


@pytest.mark.cuda
def test_benchmark_files_alone_exit_nonzero_on_a_card(tmp_path):
    need_card()
    proc = run(bench_only(tmp_path))
    assert proc.returncode != 0 and proc.stdout == ""
    assert "cupyimg_tpu_torch" in proc.stderr


@pytest.mark.cuda
def test_one_short_run_on_a_card():
    need_card()
    proc = run(CHECKOUT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert list(result)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= \
        set(result)
    assert result["correct"] is True
    assert set(result["metrics"]) == {"items_per_s", "item_p95_ms",
                                      "work_mem_gib", "setup_s"}
    assert result["device"]["platform"] == "gpu"
    assert proc.stderr.strip().splitlines()[-1].startswith("check ")


@pytest.mark.cuda
def test_one_short_traced_run_on_a_card():
    need_card()
    args = list(RUN)
    args[-1] = "1"
    proc = run(CHECKOUT, args)
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    metrics = {k: v["value"] for k, v in result["metrics"].items()}
    # uniform 1, gaussian and three sobels 4, opening 1: one launch each
    assert metrics["launches_per_item"] == 6.0
    assert 0.0 < metrics["separable_roofline"] < 100.0
    assert 0.0 <= metrics["device_idle_pct"] < 100.0
    assert -5.0 < metrics["untraced_idle_pct"] < 100.0
    assert metrics["host_issue_ms"] > 0.0
    device = result["device"]
    assert 0.0 < device["busy_s"] <= device["window_s"]
    assert len(result["breakdown"]["device_ops"]) <= 10
