"""A configuration, a mix and a per-layer metric are found by name from
files of their own: dummy ones added as new files to a copy of the
benchmark's folder are run without editing any file that was there."""

import hashlib
import json
import shutil
import time

from conftest import CHECKOUT

from portbench import harness


def digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_new_files_alone_make_a_new_cell(tmp_path):
    bench = tmp_path / "bench"
    shutil.copytree(CHECKOUT / "portbench", bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = digests(bench)
    (bench / "configs" / "dummy_cfg.json").write_text(json.dumps(
        {"source": "a test", "shape": [10, 12], "dtype": "float32",
         "pool": 3}))
    (bench / "traffic" / "dummy_mix.json").write_text(json.dumps(
        {"inflight": 3, "warm_items": 2, "check_items": 2,
         "control": "reference",
         "calls": [{"name": "box", "fn": "scipy.ndimage.uniform_filter",
                    "args": {"size": 3}, "family": "separable",
                    "bound": "separable", "limit": 1e-5}]}))
    (bench / "metrics" / "dummy.items_issued.py").write_text(
        "def read(r):\n    return float(r.traced_items)\n")
    spec = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "dummy_cfg", "source": "a test",
                            "file": "bench/configs/dummy_cfg.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "dummy.cell", "config": "dummy_cfg",
                              "traffic": "dummy_mix", "chips": 1,
                              "why": "a test"})
    for m in spec["end_to_end"]:
        if m["name"] == "items_per_s":
            m["workloads"].append("dummy.cell")
    spec["per_layer"].append({"name": "dummy.items_issued", "unit": "items",
                              "better": "higher", "source": "host_clock",
                              "layer": "a test", "moves": "items_per_s",
                              "workloads": ["dummy.cell"]})
    result = harness.run_cell("dummy.cell", 9, 0.2, True, spec,
                              time.perf_counter(), bench_dir=bench,
                              device="cpu")
    assert result["correct"] is True
    assert result["metrics"]["dummy.items_issued"]["value"] == \
        result["attempted"] > 0
    assert "separable_roofline" not in result["metrics"]  # no device here
    assert digests(bench).items() >= before.items()


def test_a_split_metric_reads_with_its_quantitys_reader(spec):
    """``<quantity>.<part>`` without a file of its own is read by
    ``metrics/<quantity>.py``, and a per-layer metric without a
    ``workloads`` list is read where the metric it moves is reported."""
    spec = json.loads(json.dumps(spec))
    for m in spec["end_to_end"]:
        if m["name"] == "items_per_s":
            m["workloads"] = ["img4096.separable"]
    spec["end_to_end"].append({"name": "items_per_s.other",
                               "unit": "items/s", "better": "higher",
                               "bound": 0.1, "source": "host_clock",
                               "workloads": ["vol256.separable"]})
    spec["per_layer"] = [
        {"name": "host_issue_ms", "unit": "ms", "better": "lower",
         "source": "host_clock", "layer": "host", "moves": "items_per_s"},
        {"name": "host_issue_ms.other", "unit": "ms", "better": "lower",
         "source": "host_clock", "layer": "host",
         "moves": "items_per_s.other"}]
    for workload, suffix in (("img4096.separable", ""),
                             ("vol256.separable", ".other")):
        cell = harness.Cell(workload, spec, device="cpu")
        e2e = [m["name"] for m, _ in cell.metrics["end_to_end"]]
        layer = [(m["name"], mod.__doc__)
                 for m, mod in cell.metrics["per_layer"]]
        assert "items_per_s" + suffix in e2e
        assert [name for name, _ in layer] == ["host_issue_ms" + suffix]
        assert layer[0][1].startswith("Mean host milliseconds")


def test_every_cell_reports_what_its_per_layer_metrics_move(spec):
    """Each cell reports ``setup_s``, another end-to-end metric and a
    per-layer one, and the end-to-end metric each of its per-layer
    metrics moves."""
    for w in spec["workloads"]:
        cell = harness.Cell(w["name"], spec, device="cpu")
        e2e = {m["name"] for m, _ in cell.metrics["end_to_end"]}
        layer = cell.metrics["per_layer"]
        assert "setup_s" in e2e and len(e2e) >= 2 and layer, w["name"]
        assert {m["moves"] for m, _ in layer} <= e2e, w["name"]
