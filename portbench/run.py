"""Run one cell of BENCHMARK.json once on the GPU and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout that holds BENCHMARK.json, this folder
and cupyimg_tpu_torch.  The last line of standard output is the result:
one JSON object with ``correct``, ``attempted``, ``failed``, ``metrics``
(the cell's end-to-end metrics, or with ``--trace 1`` its per-layer
ones), ``device`` (with ``--trace 1`` also ``busy_s`` and ``window_s``),
with ``--trace 1`` ``breakdown``, and last ``checks``: each number
compared with the reference beside its limit, also the last lines of
standard error.  Exits non-zero, printing no result, without a CUDA
device (or fewer than the cell asks for), where cupyimg_tpu_torch is not
the checkout's, or where JAX or the JAX package is loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent
# the checkout, not this folder, leads the path: the benchmark's modules
# import as the package ``portbench`` and shadow no standard module
sys.path[0] = str(CHECKOUT)
# the program's kernel caches at fixed paths inside the checkout
os.environ["TRITON_CACHE_DIR"] = str(CHECKOUT / "build" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CHECKOUT / "build" / "torch_extensions")


def fail(msg):
    print(f"portbench: {msg}", file=sys.stderr)
    sys.exit(1)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    spec_path = CHECKOUT / "BENCHMARK.json"
    if not spec_path.exists():
        fail(f"no {spec_path}")
    spec = json.loads(spec_path.read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if args.workload not in cells:
        fail(f"no workload {args.workload!r} in BENCHMARK.json")

    import torch

    t_torch = time.perf_counter()
    chips = int(cells[args.workload]["chips"])
    if not torch.cuda.is_available():
        fail("no CUDA device")
    if torch.cuda.device_count() < chips:
        fail(f"{torch.cuda.device_count()} CUDA devices, the cell asks for "
             f"{chips}")
    try:
        import cupyimg_tpu_torch
    except ImportError as exc:
        fail(f"cupyimg_tpu_torch cannot be imported: {exc}")
    if CHECKOUT not in Path(cupyimg_tpu_torch.__file__).resolve().parents:
        fail(f"cupyimg_tpu_torch from {cupyimg_tpu_torch.__file__}, not "
             "from this checkout")
    t_port = time.perf_counter()

    from portbench import harness

    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), spec, T_START,
                              phases=[("torch", t_torch), ("port", t_port)])
    found = harness.forbidden_modules()
    if found:
        fail(f"loaded after the window: {', '.join(found)}")
    for name, check in result["checks"].items():
        print(f"check {name}: {check['value']!r} (limit {check['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
