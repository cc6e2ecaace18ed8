"""Runs one cell of the benchmark once: set-up, the measured window, the
correctness check against the reference, and the result line.

Everything a cell needs is found by name: `BENCHMARK.json` lists the
cells and metrics; a configuration is `benchmark/configs/<config>.json`,
a traffic mix `benchmark/traffic/<traffic>.json` whose `kind` names the
driver `benchmark/drivers/<kind>.py`, and a per-layer metric `a.b.c` is
read by `benchmark/metrics/a.b.c.py`, or else by the file of its longest
dotted prefix (`a.b.py`).  From the system under test, `riders_tpu_torch`,
the harness takes the configuration presets, RC-Net, the SML of the
configuration's `sml.model_type` as the port's factory builds it
(`models.factory.build_sml_model`), the fused entry
(`pipelines.fused.make_fused_fn`) and the server
(`pipelines.serving.FusedServer`), and nothing else.  The SML's plain
reference is found by the same model type (`reference/chain.py`).

What the run serves is checked after the window (`check_outputs`): a
seeded sample of the served frames, the RC-Net responses the timed path
made for them (taken by a forward hook on the RC-Net it was handed) and
their depth, against the plain float32 reference in
`benchmark/reference/`.  `run_cell(..., program="control")` puts that
reference, with its networks in float8, in the program's place: the
control the limits are set against (`benchmark/control.py`).
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import sys
import time
from contextlib import nullcontext
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from benchmark.loader import load_file_module

BENCH_DIR = "benchmark"         # the benchmark's files under a checkout
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "riders_tpu")
TRACE_SECONDS = 2.0            # the profiled stretch of a traced window
TRACE_SETTLE = 0.5             # profiler running before the stretch opens
SAMPLE_FRAMES = 24             # served frames compared with the reference
WARMUP_BATCHES = 3
WEIGHT_SEED_OFFSET = 0x9E3779B9   # weights and frames draw other streams
SECTIONS = ("dataset", "alignment", "sml", "rcnet")


class CellError(Exception):
    """A cell that cannot run here: no card, too few cards, or a file or
    entry missing."""


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(root: Path, name: str):
    """(spec, cell, configuration, traffic) of cell `name`."""
    spec = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise CellError(f"no cell {name!r} in BENCHMARK.json")
    cell = cells[name]
    entry = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    config = load_json(root / entry["file"])
    traffic = load_json(root / BENCH_DIR / "traffic"
                        / f"{cell['traffic']}.json")
    return spec, cell, config, traffic


def metric_reader(root: Path, name: str):
    """The reader module of per-layer metric `name`: the file of the
    longest dotted prefix of the name under benchmark/metrics."""
    parts = name.split(".")
    for n in range(len(parts), 0, -1):
        path = root / BENCH_DIR / "metrics" / (".".join(parts[:n]) + ".py")
        if path.exists():
            return load_file_module(path, "bench_metric_" + path.stem
                                    .replace(".", "_"))
    raise CellError(f"no reader for per-layer metric {name!r}")


def port_config(config: dict):
    """The port's RidersConfig: the preset with every field the
    configuration file gives (a field the port lacks raises)."""
    from riders_tpu_torch.core import config as C
    base = {"ntu": C.ntu_config, "zju": C.zju_config}[config["preset"]]()
    sections = {}
    for sec in SECTIONS:
        cur = getattr(base, sec)
        names = {f.name for f in dataclasses.fields(cur)}
        given = config.get(sec, {})
        unknown = set(given) - names
        if unknown:
            raise CellError(f"{sec}: no such fields {sorted(unknown)}")
        sections[sec] = dataclasses.replace(cur, **{
            k: tuple(v) if isinstance(v, list) else v
            for k, v in given.items()})
    return base.replace(**sections)


def forbidden_modules() -> List[str]:
    """Modules loaded in this process whose top-level name is one of
    `FORBIDDEN`, compared whole."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def percentile(values, q: float) -> float:
    """The q-th percentile of all values, linear between order
    statistics."""
    return float(np.percentile(np.asarray(values, np.float64), q))


class Reservoir:
    """A seeded uniform sample of `size` served frames (algorithm R)."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.rng = np.random.default_rng([seed, 7])
        self.seen = 0
        self.kept: List[tuple] = []

    def offer(self, key, depth: np.ndarray, responses) -> None:
        """Frames of one served batch: its pool index, host depth and the
        device responses the call made (copied on the device, no wait)."""
        for f in range(depth.shape[0]):
            if len(self.kept) < self.size:
                j = len(self.kept)
                self.kept.append(None)
            else:
                j = int(self.rng.integers(0, self.seen + 1))
            if j < self.size:
                self.kept[j] = (key, f, depth[f].copy(),
                                responses[f].clone())
            self.seen += 1


class Session:
    """What a driver works with during the window, and what the
    per-layer readers read after it.

    Drivers call `serve(batches)` with an iterable of pool batches that
    appends each batch's pool index to `sent` before yielding it, and
    `span(name)` around host work to be named in a trace; they set
    `window_start` and `window_end` (time.perf_counter)."""

    def __init__(self, cell, config, traffic, seconds, seed, trace, device):
        self.cell, self.config, self.traffic = cell, config, traffic
        self.seconds, self.trace_on = seconds, trace
        self.device = device
        self.batch_size = traffic["batch"]
        self.pool: List[Dict[str, np.ndarray]] = []
        self.order: List[int] = []
        self.sent: List[int] = []
        self.calls: List[tuple] = []        # (start, end) of fused calls
        self.results: List[float] = []      # when each result came back
        self.hooked: List = []              # RC-Net outputs of the open call
        self.responses: List = []           # each call's responses, in order
        self.pulls: List[tuple] = []        # (when, lag) of open-loop pulls
        self.window_start = self.window_end = 0.0
        self.server = None
        self.reservoir = Reservoir(SAMPLE_FRAMES, seed)
        self.tracer = None
        self.reference = None
        self.weights = None
        self.flops_per_frame: Optional[float] = None

    @staticmethod
    def clock() -> float:
        return time.perf_counter()

    def span(self, name: str):
        if not self.trace_on:
            return nullcontext()
        from torch.profiler import record_function
        return record_function(name)

    def open_window(self, lead: float = 0.05) -> None:
        self.window_start = self.clock() + lead
        self.window_end = self.window_start + self.seconds
        if self.trace_on:
            from benchmark.trace import Tracer
            length = min(TRACE_SECONDS, self.seconds)
            self.tracer = Tracer(
                self.window_start + (self.seconds - length) / 2
                - TRACE_SETTLE, length, TRACE_SETTLE)

    def serve(self, batches):
        """The server's results as (index, depth), in order; each one
        timed, offered to the correctness sample and ticking the tracer."""
        it = self.server.run(batches)
        j = 0
        try:
            while True:
                with self.span("serve.result_wait"):
                    depth = next(it, None)
                if depth is None:
                    break
                self.results.append(self.clock())
                self.reservoir.offer(self.sent[j], depth,
                                     self.responses[j])
                self.responses[j] = None
                if self.tracer is not None:
                    self.tracer.tick()
                yield j, depth
                j += 1
        finally:
            it.close()
            if self.tracer is not None:
                self.tracer.close()

    @property
    def trace(self):
        return None if self.tracer is None else self.tracer.trace

    def before_trace(self, t: float) -> bool:
        """Whether host time `t` came before the profiler was started.
        Starting it stalls the host and leaves every later launch
        slower, so host metrics are read over the window before it."""
        return (self.tracer is None or self.tracer.requested is None
                or t < self.tracer.requested)

    def calls_in_trace(self) -> List[int]:
        """Indices of the fused calls that started inside the traced
        stretch (host clock)."""
        if self.trace is None:
            return []
        lo, hi = self.trace.host_window
        return [i for i, (s, _) in enumerate(self.calls) if lo <= s < hi]


def _entry(session: Session, fused):
    """The fused function as the server calls it, timed per call; the
    RC-Net outputs hooked during the call are kept as its responses."""
    import torch

    def call(batch):
        start = time.perf_counter()
        with session.span("entry.call"):
            out = fused(batch)
        session.calls.append((start, time.perf_counter()))
        parts, session.hooked = session.hooked, []
        if not parts:
            raise CellError("the call ran no RC-Net forward that the "
                            "benchmark could see: its responses cannot "
                            "be checked")
        session.responses.append(parts[0] if len(parts) == 1
                                 else torch.cat(parts))
        return out
    return call


def _keep_responses(session: Session, rcnet) -> None:
    """A forward hook on the RC-Net handed to the program: each output,
    (B, K, ph, pw) responses (a trailing channel of 1 dropped), is kept
    for the call that made it."""
    def hook(module, args, out):
        if out.dim() == 5:
            out = out[..., 0]
        session.hooked.append(out.detach())
    rcnet.register_forward_hook(hook)


def _range_hooks(session: Session, modules: Dict[str, object]) -> None:
    """Host ranges `<name>.forward` around each module's forward."""
    from torch.profiler import record_function
    open_ranges = {}

    def enter(name):
        def hook(module, args):
            open_ranges[name] = record_function(name + ".forward")
            open_ranges[name].__enter__()
        return hook

    def leave(name):
        def hook(module, args, out):
            open_ranges.pop(name).__exit__(None, None, None)
        return hook

    for name, m in modules.items():
        m.register_forward_pre_hook(enter(name))
        m.register_forward_hook(leave(name))


def build_program(session: Session, cfg, config: dict, program: str):
    """(fused function, RC-Net module, modules to range) of `program`:
    'port', the system under test, or 'control', the reference with its
    networks in float8 in its place."""
    import torch
    dev = session.device
    if program == "control":
        from benchmark.reference.chain import Reference
        ref = Reference(config, session.weights, dev, "fp8")
        return ref, ref.rcnet, {"rcnet": ref.rcnet, "sml": ref.sml}
    if program != "port":
        raise CellError(f"no program {program!r}")
    from riders_tpu_torch.models.factory import build_sml_model
    from riders_tpu_torch.models.rcnet import RCNet
    from riders_tpu_torch.pipelines import fused as fused_mod
    dtype = getattr(torch, config["dtype"])
    rcnet = RCNet(cfg.rcnet, dev, dtype)
    sml = build_sml_model(cfg, dev, dtype)
    rcnet.load_state_dict(session.weights["rcnet"])
    sml.load_state_dict(session.weights["sml"])
    fused = fused_mod.make_fused_fn(cfg, rcnet, sml, dev)
    return fused, rcnet, {"rcnet": rcnet, "sml": sml}


def run_cell(root: Path, name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: Optional[float] = None,
             program: str = "port") -> dict:
    """Run cell `name` once and return its result (the result line's
    keys, `checks` last).  `program='control'` serves the float8
    reference in the port's place."""
    t_start = time.perf_counter() if t_start is None else t_start
    spec, cell, config, traffic = find_cell(root, name)
    import torch
    if device == "cuda":
        if not torch.cuda.is_available():
            raise CellError("no CUDA device")
        if torch.cuda.device_count() < cell["chips"]:
            raise CellError(f"{name} needs {cell['chips']} cards, "
                            f"{torch.cuda.device_count()} present")
    dev = torch.device(device)
    from benchmark.frames import make_pool
    from benchmark.weights import make_weights
    from riders_tpu_torch.pipelines.serving import FusedServer

    session = Session(cell, config, traffic, seconds, seed, trace, dev)
    cfg = port_config(config)
    B = traffic["batch"]
    session.pool = make_pool(cfg.dataset.image_shape,
                             cfg.dataset.max_points, config["real_points"],
                             traffic["pool_batches"], B, seed, dev)
    rng = np.random.default_rng([seed, 11])
    session.order = [int(i) for i in rng.permutation(len(session.pool))]
    session.weights = make_weights(
        config, seed + WEIGHT_SEED_OFFSET, dev,
        {k: v[:1] for k, v in session.pool[0].items()})
    fused, rcnet, ranged = build_program(session, cfg, config, program)
    _keep_responses(session, rcnet)
    if trace:
        _range_hooks(session, ranged)
    session.server = FusedServer(_entry(session, fused),
                                 depth=traffic["server_depth"], device=dev)
    # warm-up: the cell's one batch shape through the server
    for _ in session.server.run(session.pool[i % len(session.pool)]
                                for i in range(WARMUP_BATCHES)):
        pass
    if trace:
        from benchmark.trace import prime_profiler
        prime_profiler(lambda: list(session.server.run(session.pool[:1])))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    session.calls.clear()
    session.responses.clear()
    # set-up's objects out of the collector's way for the window
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start

    driver = load_file_module(root / BENCH_DIR / "drivers"
                              / f"{traffic['kind']}.py",
                              "bench_driver_" + traffic["kind"])
    outcome = driver.run(session)

    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    del fused, rcnet, ranged
    session.server = None
    session.responses.clear()
    gc.unfreeze()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = check_outputs(session)
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    metrics: Dict[str, dict] = {}
    units = {m["name"]: m for m in spec["end_to_end"] + spec["per_layer"]}
    if not trace:
        for m in spec["end_to_end"]:
            if name not in m.get("workloads", [name]):
                continue
            value = setup_s if m["name"] == "setup_s" else \
                outcome["metrics"].get(m["name"])
            if value is None:
                raise CellError(f"{name}: no reading of {m['name']}")
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in spec["per_layer"]:
            if name not in m.get("workloads", [name]):
                continue
            value = metric_reader(root, m["name"]).read(session)
            if value is not None:
                metrics[m["name"]] = {"value": value,
                                      "unit": units[m["name"]]["unit"]}
    result = {"correct": correct, "attempted": outcome["attempted"],
              "failed": outcome["failed"], "metrics": metrics,
              "device": device_record(dev, cell, peak, session.trace)}
    if session.trace is not None:
        result["breakdown"] = breakdown(session.trace)
    result["checks"] = checks
    return result


def rel_mae(got, want) -> float:
    """sum |got - want| / sum |want| over everything, in float64;
    infinite where a value of `got` is not finite."""
    import torch
    got = torch.as_tensor(got).double()
    want = torch.as_tensor(want).double().to(got.device)
    if not bool(torch.isfinite(got).all()):
        return math.inf
    return float((got - want).abs().sum() / want.abs().sum())


def err_ratio(got, want, rounded) -> dict:
    """`got`'s relative error against the float32 reference `want`, in
    units of the same error of `rounded`, the reference with its
    networks stored in bfloat16: how far rounding at the configuration's
    precision moves RC-Net's responses depends on the seeded weights by
    ten times, and the ratio does not."""
    served, own = rel_mae(got, want), rel_mae(rounded, want)
    ratio = served / own if own > 0 else (0.0 if served == 0 else math.inf)
    return {"value": ratio, "served_rel_err": served, "bf16_rel_err": own}


def check_outputs(session: Session) -> Dict[str, dict]:
    """The sampled served frames against the float32 reference, each
    number beside its limit from the configuration:

    - `responses_err_ratio`: the RC-Net responses the timed path made
      for them against the reference's, from the same frames and
      weights;
    - `depth_err_ratio`: their served depth against the reference's from
      those responses on: threshold, composition, scatter, stage 1,
      SML, upsample.  The reference follows the program's responses
      because the threshold makes the depth jump where a response
      rounds across it.

    Each is the served error over the bf16 reference's (`err_ratio`)."""
    import torch
    from benchmark.frames import take
    from benchmark.reference.chain import Reference
    kept = session.reservoir.kept
    ref = session.reference = Reference(session.config, session.weights,
                                        session.device)
    b16 = Reference(session.config, session.weights, session.device,
                    "bf16")
    frames = take(session.pool, [(b, f) for b, f, _, _ in kept])
    got = torch.stack([r for _, _, _, r in kept]).float()
    served = torch.from_numpy(np.stack([d for _, _, d, _ in kept]))
    out = {"responses_err_ratio": err_ratio(got, ref.responses(frames),
                                            b16.responses(frames)),
           "depth_err_ratio": err_ratio(served, ref.depth(frames, got),
                                        b16.depth(frames, got))}
    for name, check in out.items():
        check["limit"] = session.config["limits"][name]
    return out


def device_record(dev, cell, peak: int, trace) -> dict:
    import torch
    rec = {"platform": "gpu" if dev.type == "cuda" else dev.type,
           "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                    else "cpu"),
           "count": cell["chips"], "memory_peak_bytes": int(peak)}
    if trace is not None:
        rec["busy_s"] = trace.busy_s()
        rec["window_s"] = trace.window_s
    return rec


def breakdown(trace) -> dict:
    """The ten device categories that took most time in the traced
    stretch, and its ten longest idle gaps named by the host range open
    at their start."""
    ops = list(trace.by_category().items())[:10]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in trace.gaps()[:10]]}


def describe_checks(checks: Dict[str, dict]) -> List[str]:
    return [f"check {k}: value {v['value']!r} limit {v['limit']!r}"
            for k, v in checks.items()]

