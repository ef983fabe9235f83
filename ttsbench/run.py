"""Run one cell of BENCHMARK.json once and print its result line.

    python3 ttsbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints as the last line of standard output
one JSON object (correct, attempted, failed, metrics, device, with --trace 1
the breakdown, and last the numbers compared with their limits), and the
compared numbers again as the last lines of standard error. Exits non-zero
with no result when no CUDA card (or fewer than the cell asks for) is
present, when a module of JAX or of the JAX package was loaded, or when the
port is not beside the benchmark.

The program's build and kernel caches stay inside the checkout
(`build/`), at fixed paths: only a checkout's first run builds.

The process keeps its host work on one thread (the OpenMP, MKL and
OpenBLAS pools, and torch's intra-op pool): a host shared with other load
then holds up no pool of spinning workers in the timed path.

`setup_s` runs from the moment this process holds the card's runtime
(torch imported and the card found) to the first timed request; the
seconds before it (the interpreter, torch's import and the CUDA driver's
start: no work of the program, whose modules are imported in set-up) are
printed on standard error as `process_to_card_s`."""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "build" / "ttsbench-cache"
THREADS = 1


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if not (ROOT / "pocket_tts_tpu_torch").is_dir():
        print("ttsbench: the port (pocket_tts_tpu_torch) is not in this checkout",
              file=sys.stderr)
        return 2
    os.environ.setdefault("USE_FLAX", "0")
    for pool in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[pool] = str(THREADS)
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(CACHE / "inductor")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    sys.path.insert(0, str(ROOT))
    import torch

    t_torch = time.perf_counter()
    torch.set_num_threads(THREADS)
    from ttsbench import harness

    spec = harness.cell_spec(args.workload)
    chips = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"ttsbench: needs {chips} CUDA card(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    t_card = time.perf_counter()
    result, lines = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                                     "cuda", t_card, spec)
    lines.insert(0, f"process_to_card_s {t_card - T_START!r} (import torch "
                    f"{t_torch - T_START!r}, the card found {t_card - t_torch!r})")
    found = harness.forbidden_modules()
    if found:
        print(f"ttsbench: modules of JAX or the JAX package loaded: {found}", file=sys.stderr)
        return 4
    print(json.dumps(result), flush=True)
    for line in lines:
        print(line, file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
