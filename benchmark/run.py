"""The benchmark of subgnn_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload ppi_bp.train --seed 7 --seconds 10 \
        --trace 0

runs the cell once in this process on the first CUDA device and prints, as
its last line on stdout, one JSON object: correct, attempted, failed, the
cell's end-to-end metrics (--trace 0) or its per-layer metrics (--trace 1),
the device, with --trace 1 the breakdown, and last the numbers the
correctness check compared, each with its limit (also the last lines on
stderr). Exits non-zero without printing a result when no CUDA device is
there or when JAX or the JAX package was loaded. See benchmark/README.md.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
# kernel caches at fixed paths inside the checkout (the port builds its
# nvcc and g++ libraries into build/ there itself)
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
# one process with a fixed, small number of host threads (numpy's BLAS,
# torch's intra-op pool), set before either is imported
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "4"


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def run_cell(cell, args, dev, t_process: float = T_PROCESS) -> int:
    """Run `cell` on `dev`; print the result line; 0 unless JAX was
    loaded."""
    from benchmark.harness.common import card_info, emit, forbidden_modules
    out = cell.driver().run(cell, args, dev, t_process)
    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process: {', '.join(bad)} (JAX or the JAX "
              "package); no result", file=sys.stderr)
        return 3
    checks = out["checks"]
    correct = bool(checks) and all(
        lim is not None and math.isfinite(v) and v <= lim
        for v, lim in checks.values())
    result = {"correct": correct}
    result.update(out["result"])
    result["device"].update(result.pop("device_trace", {}))
    if dev.type == "cuda":
        result["device"].update(card_info())
    emit(result, checks)
    return 0


def main(argv=None) -> int:
    args = parse(argv)
    from benchmark.harness.common import Cell
    cell = Cell(args.workload)
    import torch
    need = int(cell.spec["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"{args.workload} needs {need} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    return run_cell(cell, args, torch.device("cuda", 0))


if __name__ == "__main__":
    sys.exit(main())
