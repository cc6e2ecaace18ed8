"""Logging, metric tables, scalar summaries, image mosaics and profiling.

`log` prints and appends to a file, `log_params` dumps a configuration,
`log_evaluation_results` prints the seven-metric table, `ScalarWriter`
streams scalars (and quantile digests of arrays) as JSON lines and
mirrors them to TensorBoard where `torch.utils.tensorboard` imports,
`StepTimer` estimates elapsed and remaining time, `save_image_mosaic`
writes image / depth panels as one PNG, and `trace` records a
torch.profiler trace of its block with the port's spans
(`core.tracing`) beside it.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Dict, Optional

import numpy as np

from riders_tpu_torch.core.metrics import METRIC_KEYS


def log(message: str, filepath: Optional[str] = None) -> None:
    """Print, and append to `filepath` when given."""
    print(message)
    if filepath:
        os.makedirs(os.path.dirname(filepath) or ".", exist_ok=True)
        with open(filepath, "a") as f:
            f.write(message + "\n")


def log_params(filepath: Optional[str], params: Dict[str, Any]) -> None:
    """Dump a configuration / kwargs mapping, one key=value per line."""
    for k in sorted(params):
        log(f"{k}={params[k]}", filepath)


def log_evaluation_results(title: str, results: Dict[str, float],
                           step: int = -1,
                           log_path: Optional[str] = None) -> None:
    """The seven-metric table: a header and one row at `step`."""
    log(title + ":", log_path)
    header = "{:>8}  ".format("step") + "".join(
        "{:>10}  ".format(k.upper()) for k in METRIC_KEYS)
    row = "{:>8}  ".format(step) + "".join(
        "{:>10.4f}  ".format(float(results[k])) for k in METRIC_KEYS)
    log(header, log_path)
    log(row, log_path)


def _scalar(v) -> float:
    if hasattr(v, "detach"):
        v = v.detach().float().cpu().numpy()
    return float(np.asarray(v))


class ScalarWriter:
    """JSONL scalar stream `<directory>/scalars-<tag>.jsonl`, mirrored to
    TensorBoard (`<directory>/tb-<tag>`) when it is installed."""

    def __init__(self, directory: str, tag: str = "train"):
        os.makedirs(directory, exist_ok=True)
        self.path = os.path.join(directory, f"scalars-{tag}.jsonl")
        self._file = open(self.path, "a")
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            return
        self._tb = SummaryWriter(os.path.join(directory, f"tb-{tag}"))

    def write(self, step: int, scalars: Dict[str, Any]) -> None:
        """One record of the scalar-valued entries; others are skipped."""
        rec = {"step": int(step)}
        for k, v in scalars.items():
            try:
                rec[k] = _scalar(v)
            except (TypeError, ValueError):
                continue
        self._file.write(json.dumps(rec) + "\n")
        self._file.flush()
        if self._tb is not None:
            for k, v in rec.items():
                if k != "step":
                    self._tb.add_scalar(k, v, step)

    def write_histograms(self, step: int, arrays: Dict[str, Any]) -> None:
        """Quantile digests (min, p25, median, p75, max, mean) of arrays;
        full histograms go to TensorBoard when it is installed."""
        rec: Dict[str, Any] = {"step": int(step)}
        for k, v in arrays.items():
            if hasattr(v, "detach"):
                v = v.detach().float().cpu().numpy()
            a = np.asarray(v, np.float32).reshape(-1)
            if a.size == 0:
                continue
            q = np.quantile(a, [0.0, 0.25, 0.5, 0.75, 1.0])
            rec[k] = {"min": float(q[0]), "p25": float(q[1]),
                      "median": float(q[2]), "p75": float(q[3]),
                      "max": float(q[4]), "mean": float(a.mean())}
            if self._tb is not None:
                self._tb.add_histogram(k, a, step)
        self._file.write(json.dumps({"histograms": rec}) + "\n")
        self._file.flush()

    def close(self) -> None:
        self._file.close()
        if self._tb is not None:
            self._tb.close()


class StepTimer:
    """Steps taken, with elapsed and remaining-time estimates."""

    def __init__(self, total_steps: int):
        self.total_steps = total_steps
        self.start = time.time()
        self.steps = 0

    def tick(self, n: int = 1) -> None:
        self.steps += n

    def stats(self) -> Dict[str, float]:
        elapsed = time.time() - self.start
        rate = self.steps / elapsed if elapsed > 0 else 0.0
        remaining = ((self.total_steps - self.steps) / rate
                     if rate > 0 else float("inf"))
        return {"elapsed_h": elapsed / 3600.0,
                "remaining_h": remaining / 3600.0,
                "steps_per_s": rate}

    def format(self) -> str:
        s = self.stats()
        return (f"Step={self.steps:6d}/{self.total_steps} "
                f"Elapsed={s['elapsed_h']:.2f}h "
                f"Remaining={s['remaining_h']:.2f}h "
                f"({s['steps_per_s']:.2f} it/s)")


def _write_spans(path: str, spans, base_ns: int) -> None:
    """Write `core.tracing` spans as Chrome trace events (`ph` "X", the
    real thread id, `args` request and parent) in microseconds on the
    profiler's clock less `base_ns`, the `baseTimeNanoseconds` of the
    profiler's own trace, so that the two line up."""
    from riders_tpu_torch.core.tracing import offset_ns
    shift = offset_ns() - base_ns
    pid = os.getpid()
    events = [{"name": s.name, "ph": "X", "pid": pid, "tid": s.thread,
               "ts": (s.start_ns + shift) / 1e3,
               "dur": (s.end_ns - s.start_ns) / 1e3,
               "args": {"request": s.request, "parent": s.parent}}
              for s in spans]
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms",
                   "baseTimeNanoseconds": base_ns}, f)


def save_image_mosaic(path: str, panels, max_depth: float = 80.0) -> None:
    """Write image / depth panels as one PNG: a list of (H, W[, 3])
    arrays side by side, or a list of such lists, one mosaic row each.
    RGB panels pass through; single-channel panels are viridis-coloured
    against `max_depth`."""
    if panels and isinstance(panels[0], (list, tuple)):
        grid = [_mosaic_row(row, max_depth) for row in panels]
        width = max(r.shape[1] for r in grid)
        grid = [np.pad(r, ((0, 0), (0, width - r.shape[1]), (0, 0)))
                for r in grid]
        mosaic = np.concatenate(grid, axis=0)
    else:
        mosaic = _mosaic_row(panels, max_depth)
    from PIL import Image
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray(np.uint8(mosaic * 255)).save(path)


def _mosaic_row(panels, max_depth: float) -> np.ndarray:
    from riders_tpu_torch.io.depthio import _viridis

    rows = []
    target_h = max(p.shape[0] for p in panels)
    for p in panels:
        p = np.asarray(p, np.float32)
        if p.ndim == 2:
            p = _viridis(np.clip(p / max_depth, 0, 1))[..., :3]
        if p.max() > 1.0:
            p = p / 255.0
        if p.shape[0] != target_h:
            from PIL import Image
            scale = target_h / p.shape[0]
            img = Image.fromarray(np.uint8(np.clip(p, 0, 1) * 255))
            img = img.resize((int(p.shape[1] * scale), target_h),
                             Image.NEAREST)
            p = np.asarray(img, np.float32) / 255.0
        rows.append(np.clip(p, 0, 1))
    return np.concatenate(rows, axis=1)


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """Record a torch.profiler trace of the block (host and, where there
    is one, the card) to `<log_dir>/trace.json`, with the kernel table
    in `<log_dir>/kernels.txt` and the port's spans of every thread
    (`core.tracing`, enabled for the block) in `<log_dir>/spans.json`;
    a no-op when log_dir is None."""
    if log_dir is None:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    from riders_tpu_torch.core import tracing
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    was_enabled = tracing.RECORDER.enabled
    tracing.enable()
    start_ns = time.perf_counter_ns()
    try:
        with profile(activities=activities) as prof:
            yield prof
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    finally:
        if not was_enabled:
            tracing.disable()
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        base_ns = json.load(f).get("baseTimeNanoseconds", 0)
    _write_spans(os.path.join(log_dir, "spans.json"),
                [s for s in tracing.spans() if s.start_ns >= start_ns],
                base_ns)
    sort = ("cuda_time_total" if torch.cuda.is_available()
            else "cpu_time_total")
    with open(os.path.join(log_dir, "kernels.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by=sort, row_limit=50))
