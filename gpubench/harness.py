"""What the cells share: finding a piece by its name, seeds, timing,
percentiles, and reading a profiler trace into device spans, idle gaps and
the breakdown.  Nothing here imports the program under test."""

from __future__ import annotations

import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np



def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """The Python file ``path`` as a module of its own (a name may hold
    dots, so it is loaded by path and not imported by name)."""
    if not path.is_file():
        raise SystemExit(f"no such file: {path}")
    name = "gpubench_" + "_".join(path.relative_to(path.parents[1]).with_suffix(
        "").parts).replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def entry(entries: List[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise SystemExit(f"no {what} named {name!r} in BENCHMARK.json")


def sub_seed(seed: int, stream: int) -> int:
    """An independent 63-bit seed for one use (weights, inputs, schedule)
    of the run's ``--seed``."""
    state = np.random.SeedSequence([seed % (2 ** 64), stream])
    return int(state.generate_state(1, np.uint64)[0]) >> 1


def percentile(values, q: float) -> float:
    """Nearest-rank percentile of all ``values`` (``inf`` where a request
    never came back)."""
    if not len(values):
        return math.nan
    v = sorted(values)
    return v[max(0, math.ceil(q / 100.0 * len(v)) - 1)]


def sleep_until(t: float) -> None:
    while True:
        left = t - time.perf_counter()
        if left <= 0:
            return
        time.sleep(min(left, 0.05))


@dataclass
class Profile:
    """One profiled sub-window: device operations (kernels, copies and
    sets) and host operations as (start us, end us, name), on the
    profiler's clock, and the sub-window's bounds on that clock."""
    t0: float
    t1: float
    device: List[tuple]
    host: List[tuple]
    images: int = 0

    @property
    def seconds(self) -> float:
        return (self.t1 - self.t0) / 1e6


def profiler(device):
    """A ``torch.profiler.profile`` of the card's kernels, copies and sets,
    and of the host's CUDA calls; on the CPU, of its operations.  Host
    operations are not recorded on a card: recording every PyTorch op
    costs the host microseconds each, and the cells' host is their
    bottleneck, so they would read as device idle time that an untraced
    run does not have."""
    import torch
    act = torch.profiler.ProfilerActivity
    return torch.profiler.profile(
        activities=[act.CUDA] if device.type == "cuda" else [act.CPU])


def read_profile(prof, images: int = 0) -> Optional[Profile]:
    """The events of a ``torch.profiler.profile`` run; the sub-window runs
    from the first device operation to the end of the last (on the CPU:
    of the first and last host operation).  None where it saw nothing."""
    device, host = [], []
    for ev in prof.events():
        tr = ev.time_range
        if "CUDA" in str(getattr(ev, "device_type", "")):
            if not getattr(ev, "is_user_annotation", False):
                device.append((tr.start, tr.end, ev.key))
        else:
            host.append((tr.start, tr.end, ev.key))
    events = device or host
    if not events:
        return None
    return Profile(min(e[0] for e in events), max(e[1] for e in events),
                   device, host, images)


def device_spans(prof: Profile) -> List[tuple]:
    """(name, us) of every device operation inside the sub-window, each
    from its start, or from the end of every one before it where that is
    later, to its end: on one stream the spans add up to the union of the
    operations' intervals, the device's busy time.  (A split-K pass that
    starts while its GEMM runs counts from the GEMM's end.)"""
    spans, end = [], prof.t0
    for start, stop, key in sorted(prof.device):
        stop = min(stop, prof.t1)
        spans.append((key, max(0.0, stop - max(start, end))))
        end = max(end, stop)
    return spans


def busy_us(prof: Profile) -> float:
    return sum(us for _, us in device_spans(prof))


def is_torch_op(name: str) -> bool:
    """A kernel of PyTorch's own ops."""
    return "at::native" in name


def is_copy(name: str) -> bool:
    return "Memcpy" in name or "Memset" in name


def idle_gaps(prof: Profile) -> List[tuple]:
    """(start, end) of each stretch of the sub-window with no device
    operation."""
    gaps, end = [], prof.t0
    for start, stop, _ in sorted(prof.device):
        if start > end:
            gaps.append((end, min(start, prof.t1)))
        end = max(end, stop)
        if end >= prof.t1:
            break
    if end < prof.t1:
        gaps.append((end, prof.t1))
    return [(a, b) for a, b in gaps if b > a]


def host_doing(prof: Profile, start: float, end: float) -> str:
    """What the host was doing in an idle gap: the innermost traced host
    call running at its middle, else (the host was in Python between CUDA
    calls) the device operation it launched next."""
    t, best = (start + end) / 2, None
    for a, b, key in prof.host:
        if a <= t <= b and (best is None or b - a < best[1] - best[0]):
            best = (a, b, key)
    if best is not None:
        return best[2]
    after = [d for d in prof.device if d[0] >= end]
    return "host Python, then " + (min(after)[2] if after else "nothing")


def breakdown(prof: Profile, top: int = 10) -> Dict[str, list]:
    by_name: Dict[str, float] = {}
    for key, us in device_spans(prof):
        by_name[key] = by_name.get(key, 0.0) + us
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(idle_gaps(prof), key=lambda g: g[0] - g[1])[:top]
    return {"device_ops": [[k[:200], us / 1e6] for k, us in ops],
            "idle_gaps": [[host_doing(prof, a, b)[:200], (b - a) / 1e6]
                          for a, b in gaps]}


@dataclass
class Trace:
    """What a per-layer metric reads: the window, the benchmark's own
    spans (host seconds by name), counters, request lateness, the frozen
    counts and the profiled sub-window (None where not profiled)."""
    window_s: float
    images: int = 0
    spans: Dict[str, List[float]] = field(default_factory=dict)
    counters: Dict[str, float] = field(default_factory=dict)
    late_s: List[float] = field(default_factory=list)
    ops_per_image: float = 0.0
    least_s_per_image: float = 0.0
    profile: Optional[Profile] = None


@dataclass
class Cell:
    """One run of one cell: its entries, seed, window, device, the
    benchmark's weights and calibration batches, and the engine built
    from them (``program``: the module that reaches the program)."""
    name: str
    cfg: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: Any
    t_start: float
    layers: list
    params: dict
    calib: list
    program: Any
    engine: Any = None

    def generator(self, stream: int):
        import torch
        g = torch.Generator(device=self.device)
        g.manual_seed(sub_seed(self.seed, stream))
        return g

    def images(self, n: int, stream: int):
        """``n`` seeded NHWC float32 images on the device, one draw."""
        import torch
        h, w = self.cfg["input_hw"]
        return torch.randn((n, h, w, self.cfg["channels"]),
                           generator=self.generator(stream),
                           device=self.device)


@dataclass
class Outcome:
    """What a traffic kind's run hands back: its end-to-end values (all
    but ``setup_s``), when the window opened, the work attempted and
    failed, every answer due in the window as (rows of ``inputs``, the
    answers' probabilities), whether the inputs went through the server's
    int8 ingest, and what the per-layer metrics read."""
    metrics: Dict[str, float]
    window_open: float
    attempted: int
    failed: int
    inputs: Any
    answers: List[tuple]
    transfer: bool
    trace: Trace
    memory_peak_bytes: int = 0


def idle_pct(prof: Optional[Profile]) -> Optional[float]:
    """The share of the sub-window with no device operation, in percent."""
    if prof is None or not prof.device or prof.t1 <= prof.t0:
        return None
    return 100.0 * (1.0 - busy_us(prof) / (prof.t1 - prof.t0))
