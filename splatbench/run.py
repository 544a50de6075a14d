"""Run one cell of the benchmark once.

    python3 -m splatbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is looked up in BENCHMARK.json at the checkout's root; its
configuration is `splatbench/configs/<config>.json`, its traffic
`splatbench/traffic/<traffic>.json`, whose `driver` names
`splatbench/drivers/<driver>.py`, and each per-layer metric a reader
`splatbench/metrics/<metric>.py`; the limits of `correct` are the traffic's.
The last line of standard output is the result's JSON object; the numbers
compared with the reference also end standard error. Needs a CUDA card: without one it exits
with code 2 and prints no result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_splat")


@dataclasses.dataclass
class Context:
    cell: dict
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    t_start: float
    root: str = ROOT


def _json(path):
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: str = ROOT) -> tuple[dict, dict, dict, dict, dict]:
    """(benchmark, cell, configuration, traffic, limits) of a cell, found by
    the names in BENCHMARK.json."""
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[name]
    here = os.path.join(root, "splatbench")
    conf = _json(os.path.join(here, "configs", f"{cell['config']}.json"))
    mix = _json(os.path.join(here, "traffic", f"{cell['traffic']}.json"))
    limits = dict(mix.get("limits", {}))
    return bench, cell, conf, mix, limits


def _module(kind: str, name: str, root: str):
    path = os.path.join(root, "splatbench", kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"splatbench_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str, root: str = ROOT):
    return _module("drivers", name, root)


def metric_reader(name: str, root: str = ROOT):
    return _module("metrics", name, root).read


def end_to_end(bench: dict, cell: dict) -> set:
    """Names of the end-to-end metrics the cell reports."""
    return {m["name"] for m in bench["end_to_end"]
            if "workloads" not in m or cell["name"] in m["workloads"]}


def per_layer(bench: dict, cell: dict, trace, root: str = ROOT) -> dict:
    """The cell's per-layer metrics that its trace has something to read for."""
    e2e = end_to_end(bench, cell)
    out = {}
    for m in bench["per_layer"]:
        if "workloads" in m:
            if cell["name"] not in m["workloads"]:
                continue
        elif m["moves"] not in e2e:
            continue
        v = metric_reader(m["name"], root)(trace)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def forbidden_modules() -> list[str]:
    return sorted({k.split(".")[0] for k in sys.modules} & set(FORBIDDEN))


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return ""


def _cache_dirs():
    """Kernel and compiler caches at fixed paths inside the checkout."""
    base = os.path.join(HERE, ".cache")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(base, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(base, "triton"))


def execute(ctx: Context, bench: dict) -> dict:
    """Run the cell through its driver -> the result line (a dict)."""
    res = driver(ctx.traffic["driver"], ctx.root).run(ctx)
    checks = res["checks"]
    correct = all(v <= lim for _, v, lim, _ in checks)
    if ctx.trace:
        metrics = per_layer(bench, ctx.cell, res["trace"], ctx.root)
    else:
        own = end_to_end(bench, ctx.cell)
        metrics = {k: {"value": float(v), "unit": u} for k, (v, u) in res["metrics"].items()
                   if k in own}
    import torch

    on_card = ctx.device.type == "cuda"
    line = dict(
        correct=bool(correct), attempted=int(res["attempted"]), failed=int(res["failed"]),
        metrics=metrics,
        device=dict(platform="gpu" if on_card else "cpu",
                    kind=torch.cuda.get_device_name() if on_card else "cpu",
                    count=1, memory_peak_bytes=int(res["memory_peak_bytes"])))
    if ctx.trace:
        t = res["trace"]
        line["device"].update(busy_s=t.busy_s, window_s=t.window_s)
        line["breakdown"] = dict(device_ops=t.device_ops, idle_gaps=t.idle_gaps)
    line["checks"] = {name: {"value": v, "limit": lim} for name, v, lim, _ in checks}
    line["_detail"] = dict(checks=[list(c) for c in checks], window_s=res["window_s"],
                           steps=res["steps"], latency_ms=res.get("latency_ms"),
                           sizes=res.get("sizes"))
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    _cache_dirs()
    bench, cell, conf, mix, limits = load_cell(a.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"splatbench: needs {cell['chips']} CUDA card(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(2)  # one process with few threads: steadier host timing
    ctx = Context(cell=cell, config=conf, traffic=mix, limits=limits, seed=a.seed,
                  seconds=a.seconds, trace=bool(a.trace), device=torch.device("cuda:0"),
                  t_start=T_START)
    line, detail = finish(execute(ctx, bench))
    bad = forbidden_modules()
    if bad:
        print(f"splatbench: the run loaded {bad}", file=sys.stderr)
        return 3
    print(json.dumps(dict(detail, card=card_line())), file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


def finish(line: dict) -> tuple[dict, dict]:
    """Split the driver's detail off the result line and put the compared
    numbers last. -> (line, detail)."""
    detail = line.pop("_detail")
    line["checks"] = line.pop("checks")
    return line, detail


if __name__ == "__main__":
    sys.exit(main())
