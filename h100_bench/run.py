#!/usr/bin/env python3
"""Run one cell of the H100 benchmark of jegal_torch once.

    python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for. Set-up (timed as `setup_s`): the kernels' libraries (built into
build/ in the checkout where it has none), the cell's weights and clips
made on the card from the seed, the engine, its warm-up of every shape
the traffic meets and one warm call. Then the window: calls of the
traffic's entry back to back for `--seconds`, each started while the
window is open and run to its end. With `--trace 1` a second window (of
at most TRACED_S seconds) runs under torch.profiler, and the per-layer
metrics are read from both. After the windows the program is freed and the plain
float32 reference checks a sample of the answers (`correct`).

The last line of standard output is one JSON object: correct, attempted,
failed, metrics (the cell's end-to-end metrics, or with --trace 1 its
per-layer ones), device, with --trace 1 breakdown, and last `compared`:
each compared number with its limit, also printed as the last lines of
standard error. No card, too few cards, or a module of JAX or the JAX
package loaded: a non-zero exit and no result."""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import resource  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every cache of a run lives at a fixed path in the checkout
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
          "TRITON_CACHE_DIR": "triton", "CUDA_CACHE_PATH": "cuda"}
# numpy's BLAS on one thread a calling thread: the engine's four prep
# threads each run a log-mel product, and with BLAS's default threads on
# every core they oversubscribe the host (PERF.md: 20 % fewer frames a
# second and a wider spread in the vta cell)
THREADS = {"OPENBLAS_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}


def _set_environment(root: Path) -> None:
    """Before numpy or torch is imported: the caches' folders and BLAS's
    threads."""
    for var, sub in CACHES.items():
        path = root / "build" / "bench_cache" / sub
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)
    os.environ.update(THREADS)


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


class NoResult(Exception):
    """A run that must end with a non-zero exit and no result line."""


class Run:
    """What a finished run hands the metric readers."""

    def __init__(self):
        self.setup_s = self.window_s = self.cpu_s = self.model_flops = 0.0
        self.frames = self.graphs_before = self.graphs_after = 0
        self.trace = None
        self.traced_launches: dict = {}


def require_cards(chips: int):
    """The run's device: the first card, when there are `chips` of them."""
    import torch

    if not torch.cuda.is_available():
        raise NoResult("no CUDA card is available")
    if torch.cuda.device_count() < chips:
        raise NoResult(f"the cell asks for {chips} cards, the machine has "
                       f"{torch.cuda.device_count()}")
    return torch.device("cuda", 0)


def check_imports(when: str) -> None:
    from h100_bench.lib.imports import forbidden_modules

    bad = forbidden_modules()
    if bad:
        raise NoResult(f"{when}: loaded modules of {bad}; the port must run "
                       f"without JAX or the JAX package")


def clip_metas(cell, pool) -> list:
    """Each pool clip's shapes: frames, tokens (the piece tokenizer's
    count with <s> and </s>), words, mel frames."""
    from h100_bench.lib.tokenizer import PieceTokenizer

    vocab = cell.config.get("xlmr", {}).get("vocab_size", 250002)
    tok = PieceTokenizer(vocab)
    hop = cell.config.get("audio", {}).get("hop", 160)
    metas = []
    for c in pool:
        m = {"t": c["frames"].shape[0], "tokens": 0, "words": 0, "mel": 0}
        if "text" in c:
            words = c["text"].split(" ")
            m["tokens"] = len(tok.encode_batch([words])[0].ids)
            m["words"] = len(words)
            m["mel"] = len(c["wav"]) // hop
        metas.append(m)
    return metas


SAMPLE = 8


def sample(seed: int, k: int, order: list, metas: list) -> list:
    """Positions of call k's answers that the reference checks: the first
    of its longest clip, and SAMPLE - 1 others drawn from (seed, k)."""
    import numpy as np

    longest = max(range(len(order)), key=lambda p: metas[order[p]]["t"])
    rest = [p for p in range(len(order)) if p != longest]
    rng = np.random.default_rng([int(seed), 24, int(k)])
    n = min(SAMPLE - 1, len(rest))
    return [longest] + sorted(int(p) for p in rng.choice(rest, n,
                                                         replace=False))


def window(cell, engine, pool, metas, seed: int, seconds: float, first: int,
           kept: list, on_call=None):
    """Calls back to back while `seconds` have not passed since the start,
    each run to its end. -> (calls made, host seconds to the end of the
    last, frames returned, clips attempted, clips failed). The sampled
    answers are copied into `kept` as (pool index, answer)."""
    import numpy as np

    from h100_bench.lib import traffic

    entry = cell.entry
    calls = frames = attempted = failed = 0
    took = []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        k = first + calls
        order = traffic.call_order(cell.mix, seed, k)
        t1 = time.perf_counter()
        res = (on_call or entry.call)(engine, cell.mix,
                                      [pool[i] for i in order])
        took.append(time.perf_counter() - t1)
        for p, i in enumerate(order):
            attempted += 1
            if res[p] is None:
                failed += 1
            else:
                frames += metas[i]["t"]
        for p in sample(seed, k, order, metas):
            if res[p] is not None:
                kept.append((order[p], {n: np.array(v, np.float32)
                                        for n, v in res[p].items()}))
        calls += 1
    log("calls (s): " + " ".join(f"{x:.3f}" for x in took))
    return calls, time.perf_counter() - t0, frames, attempted, failed


def compare(cell, weights, pool, kept: list, device):
    """The float32 reference's outputs for every sampled pool clip, and
    each compared number: over every kept answer, the largest gap to the
    reference of any element, over the root mean square of the
    reference's output for that clip."""
    import numpy as np

    from h100_bench.reference import common

    refs = {}
    with common.precision(tf32=False):
        for i in sorted({i for i, _ in kept}):
            refs[i] = {k: v.float().cpu().numpy() for k, v in
                       cell.reference.run(weights, cell.config, pool[i],
                                          device).items()}
    numbers = {name: 0.0 for name in cell.limits}
    for i, answer in kept:
        for name in cell.limits:
            got, want = answer.get(name), refs[i][name]
            if got is None or got.shape != want.shape:
                numbers[name] = float("inf")
                continue
            rms = float(np.sqrt(np.mean(want.astype(np.float64) ** 2)))
            gap = float(np.max(np.abs(got.astype(np.float64) - want)))
            numbers[name] = max(numbers[name], gap / max(rms, 1e-30)
                                if np.isfinite(gap) else float("inf"))
    return numbers


def card_state() -> str:
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def execute(args, device=None, on_call=None, root: Path = ROOT) -> dict:
    """One run of the cell -> the result object. `device`, `on_call` and
    `root` are for the CPU tests: a device that skips the look for cards,
    a call that stands in for the entry's, and a checkout whose
    BENCHMARK.json and data files name other cells."""
    import torch

    from h100_bench.lib import cells, traffic
    from h100_bench.lib.weights import make_weights

    cell = cells.load(args.workload, root)
    on_card = device is None
    if on_card:
        device = require_cards(cell.chips)
    seed = args.seed
    marks = [("start", time.perf_counter())]
    weights = make_weights(cell.config, seed, device)
    marks.append(("weights", time.perf_counter()))
    pool = traffic.make_pool(cell.mix, seed, device)
    metas = clip_metas(cell, pool)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    marks.append((f"{len(pool)} clips", time.perf_counter()))
    engine = cell.system.build(cell.config, weights, device)
    marks.append(("engine", time.perf_counter()))
    log(f"set-up: imports and card {marks[0][1] - T_START:.3f} s, " + ", ".join(
        f"{name} {t1 - t0:.3f} s" for (_, t0), (name, t1)
        in zip(marks, marks[1:])))
    # a call's clips are the pool repeated, so every call asks for the same
    # chunks: the entry's graphs are captured ahead (where it has any), and
    # the warm call meets every shape of the traffic
    order = traffic.call_order(cell.mix, seed, 0)
    for chunk, secs in getattr(cell.entry, "warm", lambda *a: [])(
            engine, cell.mix, [metas[i] for i in order]):
        log(f"set-up: captured {chunk} in {secs:.3f} s")
    t = time.perf_counter()
    before = len(engine.cached_graphs)
    (on_call or cell.entry.call)(engine, cell.mix, [pool[i] for i in order])
    log(f"set-up: warm call {time.perf_counter() - t:.3f} s, "
        f"{len(engine.cached_graphs) - before} more graphs captured")
    if on_card:
        torch.cuda.synchronize()
    check_imports("after set-up")

    run = Run()
    run.setup_s = time.perf_counter() - T_START
    kept: list = []
    run.graphs_before = len(engine.cached_graphs)
    ru0 = resource.getrusage(resource.RUSAGE_SELF)
    calls, run.window_s, run.frames, attempted, failed = window(
        cell, engine, pool, metas, seed, args.seconds, 1, kept, on_call)
    ru1 = resource.getrusage(resource.RUSAGE_SELF)
    run.graphs_after = len(engine.cached_graphs)
    run.cpu_s = (ru1.ru_utime + ru1.ru_stime) - (ru0.ru_utime + ru0.ru_stime)
    sizes = [metas[i] for k in range(1, 1 + calls)
             for i in traffic.call_order(cell.mix, seed, k)]
    run.model_flops = sum(cell.system.model_flops(cell.config, m)
                          for m in sizes)
    log(f"window: {calls} calls, {run.frames} frames in {run.window_s:.3f} s,"
        f" {failed} of {attempted} clips failed")
    if args.trace:
        run.trace, run.traced_launches, t_calls = traced_window(
            cell, engine, pool, metas, seed, args.seconds, 1 + calls, kept)
        attempted += t_calls[0]
        failed += t_calls[1]
    memory_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    check_imports("after the window")
    if on_card:
        log(f"card: {card_state()}")

    engine.close()
    del engine
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    ref_weights = make_weights(cell.config, seed, device)
    numbers = compare(cell, ref_weights, pool, kept, device)
    log(f"reference: {len({i for i, _ in kept})} clips, {len(kept)} answers "
        f"in {time.perf_counter() - t:.3f} s")

    metrics_list = cell.per_layer if args.trace else cell.end_to_end
    metrics = {}
    for m in metrics_list:
        value = cells.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(memory_peak)}
    out = {"correct": None, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": dev}
    if run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        out["breakdown"] = {"device_ops": run.trace.device_ops(),
                            "idle_gaps": run.trace.idle_gaps()}
    ok = failed == 0 and all(numbers[k] <= lim
                             for k, lim in cell.limits.items())
    out["correct"] = bool(ok)
    out["compared"] = {k: {"value": numbers[k], "limit": lim}
                       for k, lim in cell.limits.items()}
    out["compared"]["failed_clips"] = {"value": failed, "limit": 0}
    return out


# The traced window's length at most: reading a trace takes ~2 s a second
# of the tower's eager window (its ~4,000 device ops a second), and a
# whole run must end within 360 s.
TRACED_S = 20.0


def traced_window(cell, engine, pool, metas, seed, seconds, first, kept):
    """The second window, under the profiler, of at most TRACED_S seconds:
    its calls, the launches they made by kernel family, and the reduced
    trace."""
    import torch
    from torch.profiler import record_function

    from h100_bench.lib import profiling, traffic

    def call(eng, mix, clips):
        with record_function("bench.call"):
            return cell.entry.call(eng, mix, clips)

    with profiling.profiled() as prof:
        calls, _, _, attempted, failed = window(
            cell, engine, pool, metas, seed, min(seconds, TRACED_S), first,
            kept, call)
        torch.cuda.synchronize()
    t = time.perf_counter()
    trace = profiling.Trace(prof)
    if trace.lost:
        log(f"profiler window: lost {trace.lost} of its {prof.lead_in} "
            f"lead-in kernels")
    launches: dict = {}
    for k in range(first, first + calls):
        order = traffic.call_order(cell.mix, seed, k)
        for chunk in cell.entry.chunks(cell.mix, [metas[i] for i in order]):
            for fam, work in cell.system.launched(cell.config, chunk).items():
                launches.setdefault(fam, []).extend(work)
    log(f"traced window: {calls} calls, {len(trace.device)} device ops, "
        f"busy {trace.busy_s:.3f} of {trace.window_s:.3f} s; read in "
        f"{time.perf_counter() - t:.3f} s")
    return trace, launches, (attempted, failed)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _set_environment(ROOT)
    # the checkout's root, in place of this script's folder
    sys.path[0] = str(ROOT)
    try:
        out = execute(args)
    except NoResult as e:
        log(f"no result: {e}")
        return 2
    for name, c in out["compared"].items():
        log(f"compared {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
