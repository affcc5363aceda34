"""Run one cell of the port's benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up builds the cell's inputs from the seed, loads the kernel library
(built on the first run in this checkout, into ``build/nsgp_kernels``) and
makes one warm-up call.  The window is a closed loop: calls back to back on
inputs cycled in order, ending at the first call that ends after
``--seconds``.  With ``--trace 1`` a few calls more run under
``torch.profiler`` and the per-layer metrics are read from that trace.
Then one call's outputs, drawn from the seed, are compared with the plain
reference (``reference.py``); ``correct`` says whether every number stayed
within its limit.  The last line of standard output is the result, as JSON.
"""

from __future__ import annotations

import time

_T_IMPORT = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
BUILD = ROOT / "build" / "benchmark"
FORBIDDEN = ("jax", "jaxlib", "flax", "nsgp_tpu")  # top-level module names
TRACE_MIN_S, TRACE_MAX_CALLS = 1.0, 8


def process_start() -> float:
    """Wall-clock time at which this process started (Linux), else the time
    this module was first imported."""
    try:
        ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        boot = next(float(line.split()[1]) for line in Path("/proc/stat").read_text().splitlines()
                    if line.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return _T_IMPORT


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def quantile(xs, q: float) -> float:
    """The q-quantile of all of xs (inclusive method)."""
    if len(xs) == 1:
        return xs[0]
    return statistics.quantiles(xs, n=100, method="inclusive")[round(100 * q) - 1]


def run_cell(man, name: str, seed: int, seconds: float, trace: bool, device: str,
             t_start: float, traffic_overrides: dict | None = None) -> dict:
    """One run of a cell: set-up, window, optional traced segment, check.
    Returns the result object (without ``device``)."""
    import numpy as np
    import torch

    cell = man.cell(name)
    traffic = dict(man.traffic(cell["traffic"]), **(traffic_overrides or {}))
    job = man.entry(traffic["entry"]).Job(man.config(cell["config"]), traffic, seed, device)
    if torch.device(device).type == "cuda":
        from nsgp_tpu_torch.ops import _build

        _build.library()
    job.call(0)  # warm-up at the cell's shapes
    setup_s = time.time() - t_start

    times, last, attempted, failed, samples = [], {}, 0, 0, 0
    t_begin = time.perf_counter()
    while True:
        i = attempted
        attempted += 1
        t0 = time.perf_counter()
        try:
            out = job.call(i)
        except Exception:  # a call that fails counts as failed; the loop goes on
            traceback.print_exc()
            failed += 1
            out = None
        t1 = time.perf_counter()
        if out is not None:
            times.append(t1 - t0)
            samples += job.samples
            last[i % job.n_inputs] = job.keep(out)
        del out
        if t1 - t_begin >= seconds:
            break
    elapsed = t1 - t_begin
    peak = torch.cuda.max_memory_allocated() if torch.device(device).type == "cuda" else 0

    result = {"attempted": attempted, "failed": failed}
    if trace:
        tr = traced_segment(job, attempted, device, cell["name"])
        tr.work = job.work()
        tr.call_s = statistics.median(times) if times else 0.0
        metrics = {}
        for m in man.per_layer(name):
            value = man.metric(m["name"]).read(tr)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["metrics"] = metrics
        result["trace"] = {"busy_s": tr.busy_s, "window_s": tr.window_s,
                           "device_ops": tr.top_kernels(), "idle_gaps": tr.idle_gaps()}
    else:
        rate = samples / elapsed if elapsed > 0 else 0.0
        values = {"samples_per_s": rate, "batch_samples_per_s": rate,
                  "call_p95_s": quantile(times, 0.95) if times else math.inf,
                  "setup_s": setup_s}
        result["metrics"] = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                             for m in man.end_to_end(name)}
    result["memory_peak_bytes"] = peak

    # The check: one input's last outputs, drawn from the seed, against the
    # plain reference, once the program's state is freed.
    done = sorted(last)
    checks = {}
    limits = man.limits(name)
    if done:
        k = done[int(np.random.default_rng([int(seed) % (1 << 63), 7]).integers(len(done)))]
        kept = {key: v.detach().cpu() for key, v in last[k].items()}
        last.clear()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        try:
            with torch.inference_mode():
                readings = job.compare(kept, job.reference(k), k)
        except Exception:
            traceback.print_exc()
            readings = {}
        for key, limit in limits.items():
            checks[key] = {"value": readings.get(key, math.inf), "limit": limit}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    result["correct"] = bool(done) and failed == 0 and bool(checks) and ok
    result["checks"] = checks
    return result


def traced_segment(job, first: int, device: str, cell: str):
    """A few more calls under torch.profiler; their Chrome trace, read back."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from benchmark.traced import CALL_SPAN, read_chrome_trace

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        calls, t0 = 0, time.perf_counter()
        while calls < TRACE_MAX_CALLS and (calls < 1 or time.perf_counter() - t0 < TRACE_MIN_S):
            with record_function(CALL_SPAN):
                job.call(first + calls)
            calls += 1
    BUILD.mkdir(parents=True, exist_ok=True)
    path = BUILD / f"trace_{cell}.json"
    prof.export_chrome_trace(str(path))
    return read_chrome_trace(path, calls)


def main(argv=None) -> int:
    t_start = process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # Caches the program or CUDA might write stay inside this checkout.
    os.environ.setdefault("CUDA_CACHE_PATH", str(BUILD / "cuda_cache"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(BUILD / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD / "triton"))
    os.environ["USE_FLAX"] = "0"
    if Path(sys.path[0]).resolve() == Path(__file__).resolve().parent:
        sys.path[0] = str(ROOT)  # run as a script: import from the checkout's root
    else:
        sys.path.insert(0, str(ROOT))

    from benchmark.manifest import Manifest

    man = Manifest()
    cell = man.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    res = run_cell(man, args.workload, args.seed, args.seconds, bool(args.trace), "cuda",
                   t_start)
    bad = forbidden_modules()
    if bad:
        print(f"the run loaded {bad}: the benchmark runs the port alone", file=sys.stderr)
        return 3

    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
              "memory_peak_bytes": res["memory_peak_bytes"]}
    out = {"correct": res["correct"], "attempted": res["attempted"], "failed": res["failed"],
           "metrics": res["metrics"], "device": device}
    if args.trace:
        t = res["trace"]
        device.update(busy_s=t["busy_s"], window_s=t["window_s"])
        out["breakdown"] = {"device_ops": t["device_ops"], "idle_gaps": t["idle_gaps"]}
    out["checks"] = res["checks"]
    for key, c in res["checks"].items():
        print(f"check {key} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
