"""Readings for the limits of `correct`, on the card: for each seed, one
run of a cell with a short window, then the compared numbers of the
program against the float32 reference and of each control (the
reference computed at a lower precision in the program's place:
"float8" for the whole model, "float8:<prefix>" for one part of it).
Not part of a benchmark run.

    python3 ttsbench/control.py --workload <cell> --seeds 11 12 13 --seconds 5 \
        [--precisions float32 float8 ...] [--parts]

Prints one JSON line per seed and precision."""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

PARTS = ("float8:flow_lm.transformer", "float8:flow_lm.flow_net", "float8:mimi.encoder",
         "float8:mimi.upsample", "float8:mimi.decoder_transformer", "float8:mimi.decoder.")


def readings(workload: str, seeds: list[int], seconds: float, precisions: list[str],
             device: str = "cuda", spec: dict | None = None):
    from ttsbench import correct, harness

    spec = spec or harness.cell_spec(workload)
    for seed in seeds:
        run = harness.Run(spec, seed, seconds, False, device, time.perf_counter())
        try:
            run.setup()
            run.window()
            run.free_program()
            for p in precisions:
                checks, ok = correct.check(run, p)
                line = dict(workload=workload, seed=seed, precision=p,
                            correct=ok, requests=len(run.records),
                            frames=run.reference_frames, reference_s=run.reference_s,
                            errors=run.item_errors, **run.worst)
                line.update({k: c["value"] for k, c in checks.items()})
                yield line
        finally:
            run.tmp.cleanup()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--precisions", nargs="+", default=["float32", "float8"])
    p.add_argument("--parts", action="store_true", help="add the float8 control of each part")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 3
    precisions = args.precisions + (list(PARTS) if args.parts else [])
    for line in readings(args.workload, args.seeds, args.seconds, precisions):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
