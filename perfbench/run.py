#!/usr/bin/env python3
"""Runs one cell of the benchmark of ``fragnet_tpu_torch`` once:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell is an entry of ``workloads`` in ``BENCHMARK.json``; it names a
configuration (``perfbench/configs/<config>.json``) and a traffic mix
(``perfbench/traffic/<traffic>.json``), which names its driver
(``perfbench/drivers/<driver>.py``). Each metric is read by
``perfbench/metrics/<metric>.py``, or by the file of the part of its name
before the first dot. Set-up builds the kernels (first run in a checkout),
reads the molecule pool from ``perfbench/cache/`` (featurizing it on the
first run), pads and packs the batches, builds the model from the seed and
runs its first steps, which the reference checks after the window. With
``--trace 0`` the window runs ``--seconds`` seconds and the end-to-end
metrics are printed; with ``--trace 1`` the traffic's ``trace_steps``
steps run under ``torch.profiler`` and the per-layer metrics are printed.
The last line of standard output is the result as one JSON object.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import hashlib  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
CACHE = os.path.join(BENCH, "cache")
# host work on one thread per process; the kernel caches inside the
# checkout, at fixed paths
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[_var] = "1"
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["CUDA_CACHE_PATH"] = os.path.join(CACHE, "cuda")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "fragnet_tpu")


class Context:
    """What a driver gets: the cell's configuration and traffic, the seed
    and the device."""

    def __init__(self, workload, config, traffic, seed, device, workers):
        self.workload = workload
        self.config = config
        self.traffic = traffic
        self.seed = int(seed)
        self.device = device
        self.workers = workers
        self.marks = []

    def mark(self, stage: str) -> None:
        """Note the end of a set-up stage (seconds since the start)."""
        self.marks.append((stage, time.perf_counter() - T0))

    def sub_seed(self, tag: str) -> int:
        """A 63-bit seed for one use, derived from the run's seed."""
        h = hashlib.sha256(f"{self.seed}:{tag}".encode()).digest()
        return int.from_bytes(h[:8], "little") >> 1


class Reading:
    """What a metric reader gets."""

    def __init__(self, session, setup_s=None, window_s=None, steps=0,
                 step_ms=None, traced=None):
        self.session = session
        self.setup_s = setup_s
        self.window_s = window_s
        self.steps = steps
        self.step_ms = step_ms or []
        self.traced = traced


def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(path):
    with open(path) as f:
        return json.load(f)


def cell_parts(man, name):
    cells = {c["name"]: c for c in man["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}")
    cell = cells[name]
    conf = {c["name"]: c for c in man["configs"]}[cell["config"]]
    config = _json(os.path.join(ROOT, conf["file"]))
    traffic = _json(os.path.join(BENCH, "traffic", f"{cell['traffic']}.json"))
    return cell, config, traffic


def metrics_for(man, cell_name, section):
    return [m for m in man[section]
            if cell_name in m.get("workloads", [cell_name])]


def reader(name):
    """The ``read`` function of the metric's file."""
    for stem in (name, name.split(".")[0]):
        path = os.path.join(BENCH, "metrics", f"{stem}.py")
        if os.path.exists(path):
            spec = importlib.util.spec_from_file_location(
                f"perfbench_metric_{stem.replace('.', '_')}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    raise SystemExit(f"no reader for metric {name!r}")


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed_window(session, seconds, device):
    """Steps dispatched for ``seconds`` of the host's clock, a CUDA event
    after each on the stream and no synchronize among them; the window
    closes when the device has finished the last step. Returns (setup_s,
    window_s, steps, step ms)."""
    import torch

    session.begin_window()
    _sync(device)
    t0 = time.perf_counter()
    setup_s = t0 - T0
    cuda = device.type == "cuda"
    marks = []
    if cuda:
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[0].record()
    else:
        marks.append(t0)
    n = 0
    while time.perf_counter() - t0 < seconds:
        session.step()
        n += 1
        if cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            marks.append(e)
        else:
            marks.append(time.perf_counter())
    _sync(device)
    window_s = time.perf_counter() - t0
    if cuda:
        step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    else:
        step_ms = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    return setup_s, window_s, n, step_ms


def traced_window(session, n_steps, device):
    """``n_steps`` steps under ``torch.profiler``; the host's time inside
    each step call is taken under the profiler."""
    import torch

    from perfbench.common import trace

    session.begin_window()
    _sync(device)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    host_ms = []
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            h0 = time.perf_counter()
            session.step()
            host_ms.append((time.perf_counter() - h0) * 1e3)
        _sync(device)
        window_s = time.perf_counter() - t0
    dev, host = trace.events(prof)
    return trace.Traced(device=dev, host=host, window_s=window_s,
                        busy_s=trace.busy_seconds(dev),
                        steps=list(session.done), host_step_ms=host_ms)


def build_kernels(device) -> None:
    """Builds the port's CUDA kernels that are not built yet (a checkout's
    first run), one nvcc per source at once."""
    if device.type != "cuda":
        return
    from fragnet_tpu_torch.ops import _cuda, dense_gat, tcsr_gat  # noqa: F401

    _cuda.build_all(_cuda.REGISTRY)


def _finite(x):
    return isinstance(x, (int, float)) and math.isfinite(x)


def run_cell(workload, seed, seconds, traced, device=None, workers=None,
             man=None, parts=None):
    """One run; returns (result dict, [(check, value, limit)]). ``device``
    None looks for the cell's CUDA devices; ``parts`` (cell, configuration,
    traffic) replaces the manifest's files."""
    import torch

    man = man or manifest()
    cell, config, traffic = parts or cell_parts(man, workload)
    if device is None:
        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < cell["chips"]:
            raise SystemExit(f"{workload} needs {cell['chips']} CUDA "
                             f"device(s); found none or too few")
        device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = bool(config.get("tf32", False))
    torch.backends.cudnn.allow_tf32 = bool(config.get("tf32", False))
    build_kernels(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.zeros(1, device=device)  # the context, before its counters
        torch.cuda.reset_peak_memory_stats(device)
    if workers is None:
        workers = max(1, min(7, (os.cpu_count() or 2) - 1))
    ctx = Context(workload, config, traffic, seed, device, workers)
    driver = importlib.import_module(f"perfbench.drivers.{traffic['driver']}")
    ctx.mark("imports and kernels")
    session = driver.Session(ctx)
    print("set-up: " + ", ".join(f"{k} {v:.2f} s" for k, v in ctx.marks),
          flush=True)

    if traced:
        tr = traced_window(session, traffic["trace_steps"], device)
        reading = Reading(session, traced=tr)
    else:
        setup_s, window_s, n, step_ms = timed_window(session, seconds,
                                                     device)
        reading = Reading(session, setup_s, window_s, n, step_ms)
        print(f"window: {n} steps in {window_s:.3f} s; step_ms_p95 over "
              f"{len(step_ms)} samples", flush=True)
        if hasattr(session, "describe"):
            print(session.describe(window_s), flush=True)
    peak = int(torch.cuda.max_memory_allocated(device)) \
        if device.type == "cuda" else 0
    counts = session.end_window()
    section = "per_layer" if traced else "end_to_end"
    metrics = {}
    for m in metrics_for(man, workload, section):
        v = reader(m["name"])(reading)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    session.release()
    limits = traffic["limits"]
    try:
        numbers = session.numbers()
    except (RuntimeError, ValueError) as exc:
        print(f"reference comparison failed: {exc!r}", file=sys.stderr)
        numbers = {k: float("nan") for k in limits}
    checks = [(k, numbers.get(k, float("nan")), limits[k]) for k in limits]
    correct = counts["failed"] == 0 and all(
        _finite(v) and v <= lim for _, v, lim in checks)

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device)
           if device.type == "cuda" else "cpu",
           "count": cell["chips"], "memory_peak_bytes": peak}
    result = {"correct": bool(correct), "attempted": counts["attempted"],
              "failed": counts["failed"], "metrics": metrics, "device": dev}
    if traced:
        from perfbench.common import trace

        dev["busy_s"] = reading.traced.busy_s
        dev["window_s"] = reading.traced.window_s
        result["breakdown"] = {
            "device_ops": [[n, s] for n, s in
                           trace.by_name(reading.traced.device)[:10]],
            "idle_gaps": [[n, s] for n, s in trace.idle_gaps(
                reading.traced.device, reading.traced.host)]}
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, v, lim in checks}
    return result, checks


def loaded_forbidden():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    result, checks = run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace))
    bad = loaded_forbidden()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    for k, v, lim in checks:
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
