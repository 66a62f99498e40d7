#!/usr/bin/env python3
"""The readings that a cell's limits are set from, on the card at the
cell's own size (the benchmark's runs never run this):

    python3 h100_bench/control.py --workload <cell> --seeds 1,2,3 \
        [--calls 2] [--out FILE]

For each seed, in one process: the cell's weights, pool and engine, its
warm call, then `--calls` calls of the traffic, every answer of them
compared with the plain float32 reference (the program's reading), and
the control: the same reference computed with TF32 on for matmuls and
cuDNN convolutions, the nearest precision below float32, compared with
the float32 reference on the same clips (the control's reading). A
number's limit lies above every program reading and below every control
reading (PERF.md gives both). One JSON line a seed on standard output,
and all of them in `--out`."""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def read_seed(cell, seed: int, calls: int, device) -> dict:
    import numpy as np
    import torch

    from h100_bench import run as R
    from h100_bench.lib import traffic
    from h100_bench.lib.weights import make_weights

    t0 = time.perf_counter()
    weights = make_weights(cell.config, seed, device)
    pool = traffic.make_pool(cell.mix, seed, device)
    engine = cell.system.build(cell.config, weights, device)
    kept: list = []
    for k in range(calls + 1):          # call 0 warms up, as in a run
        order = traffic.call_order(cell.mix, seed, k)
        res = cell.entry.call(engine, cell.mix, [pool[i] for i in order])
        if k == 0:
            continue
        for i, r in zip(order, res):
            if r is None:
                raise RuntimeError(f"seed {seed}: clip {i} came back None")
            kept.append((i, {n: np.array(v, np.float32)
                             for n, v in r.items()}))
    engine.close()
    del engine, weights
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref_w = make_weights(cell.config, seed, device)
    program = R.compare(cell, ref_w, pool, kept, device)
    # the control: the reference one precision step down, in the
    # program's place, against the float32 reference on the same clips
    ctl_kept = []
    from h100_bench.reference import common

    with common.precision(tf32=True):
        for i in sorted({i for i, _ in kept}):
            ctl_kept.append((i, {k: v.float().cpu().numpy() for k, v in
                                 cell.reference.run(ref_w, cell.config,
                                                    pool[i], device).items()}))
    control = R.compare(cell, ref_w, pool, ctl_kept, device)
    return {"seed": seed, "answers": len(kept), "program": program,
            "control": control, "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--calls", type=int, default=2)
    p.add_argument("--out")
    args = p.parse_args(argv)
    sys.path[0] = str(ROOT)
    from h100_bench import run as R

    R._set_environment(ROOT)
    from h100_bench.lib import cells

    cell = cells.load(args.workload)
    device = R.require_cards(cell.chips)
    R.log(f"card: {R.card_state()}")
    rows = []
    for s in args.seeds.split(","):
        row = read_seed(cell, int(s), args.calls, device)
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {name: {"program_max": max(r["program"][name] for r in rows),
                      "control_min": min(r["control"][name] for r in rows)}
               for name in cell.limits}
    print(json.dumps({"workload": args.workload, "summary": summary}),
          flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"rows": rows, "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
