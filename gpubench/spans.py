"""The program's own spans and sync counter on a profile's clock.

A recording is what ``feathercnn_tpu_torch.utils.profiling.record()``
hands over, read here by its fields alone: ``spans`` (``run`` spans, one
an ``Engine.run`` call, and ``node`` spans, one a graph node's lowering,
in host nanoseconds), ``syncs`` (the synchronizing CUDA calls made inside
``run`` spans, each with the innermost open node) and ``anchor_ns`` (host
nanoseconds before and after each of a few ``torch.cuda.synchronize()``
calls on an idle card, taken as the recording started inside the
profiler's block).  The narrowest bracket's midpoint is the midpoint of
its ``cudaDeviceSynchronize`` event in the profile; ``aligned`` puts every
span and sync on the profile's clock (microseconds, as
``harness.read_profile`` gives them) by that one offset.

From there: each device operation is joined to its launch (the host
runtime event of the same correlation id) and through it to the node span
the launch lies in; the three readings the recording gives (syncs per
batch, host milliseconds in sync calls per batch, device microseconds per
image in ``Eltwise`` nodes' kernels); and idle gaps named by what the
program was doing.  Nothing here imports the program."""

from __future__ import annotations

import bisect
from dataclasses import dataclass
from typing import List, Optional, Tuple

from harness import Profile, device_spans, host_doing, idle_gaps

# Host runtime calls that wait for the card: the stream and device syncs,
# an event's, and the synchronous copy (not ``cudaMemcpyAsync``).
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy")
ANCHOR_CALL = "cudaDeviceSynchronize"


def is_launch(name: str) -> bool:
    """A kernel launch's runtime event (runtime or driver API)."""
    return name.startswith(("cudaLaunchKernel", "cuLaunchKernel"))


@dataclass
class Aligned:
    """A recording on a profile's clock: (start us, end us, span) of every
    span, (us, sync) of every sync, and the anchor bracket's width.  Spans
    of one kind do not overlap (one thread, no ``Engine.run`` inside a
    node), so the span of a kind that holds a time is found by bisection."""
    spans: List[tuple]
    syncs: List[tuple]
    bracket_us: float

    def __post_init__(self):
        self.by_kind = {k: sorted(s for s in self.spans if s[2].kind == k)
                        for k in ("run", "node")}
        self.starts = {k: [s[0] for s in v] for k, v in self.by_kind.items()}

    @property
    def runs(self) -> List[tuple]:
        return self.by_kind["run"]

    def holding(self, t: float, kind: str):
        """The span of ``kind`` that holds ``t``, else None."""
        i = bisect.bisect_right(self.starts[kind], t) - 1
        if i >= 0 and self.by_kind[kind][i][1] >= t:
            return self.by_kind[kind][i][2]
        return None

    def innermost(self, t: float):
        """The node span that holds ``t``, else the run span, else None."""
        return self.holding(t, "node") or self.holding(t, "run")

    def in_run(self, t: float) -> bool:
        return self.holding(t, "run") is not None


def aligned(recording, profile: Profile) -> Optional[Aligned]:
    """``recording`` on ``profile``'s clock, or None where it has no anchor
    or the profile fewer ``cudaDeviceSynchronize`` events than brackets.
    The i-th bracket is the i-th such event; the narrowest is the anchor."""
    brackets = list(recording.anchor_ns) if recording is not None else []
    syncs = sorted(h for h in profile.host if h[2] == ANCHOR_CALL)
    if not brackets or len(syncs) < len(brackets):
        return None
    i = min(range(len(brackets)),
            key=lambda j: brackets[j][1] - brackets[j][0])
    a, b = brackets[i]
    host_mid_ns = (a + b) / 2
    prof_mid_us = (syncs[i][0] + syncs[i][1]) / 2

    def us(t_ns: int) -> float:
        return prof_mid_us + (t_ns - host_mid_ns) / 1e3

    return Aligned([(us(s.t0_ns), us(s.t1_ns), s) for s in recording.spans],
                   [(us(s.t_ns), s) for s in recording.syncs],
                   (b - a) / 1e3)


def correlated(prof) -> List[tuple]:
    """(start, end, name, launch) of every device operation of a
    ``torch.profiler.profile`` run, as ``harness.read_profile`` reads them
    (user annotations left out), where ``launch`` is (start, end, name) of
    the host runtime event that shares its correlation id, or None."""
    host, device = {}, []
    for ev in prof.events():
        tr = ev.time_range
        if "CUDA" in str(getattr(ev, "device_type", "")):
            if not getattr(ev, "is_user_annotation", False):
                device.append((tr.start, tr.end, ev.key, ev.id))
        elif ev.id:
            host[ev.id] = (tr.start, tr.end, ev.key)
    return [(a, b, k, host.get(i) if i else None) for a, b, k, i in device]


def is_copy_out(name: str, launch, al: Aligned) -> bool:
    """The harness's copy of each batch's probabilities to the host: a
    device-to-host copy queued outside every ``run`` span."""
    return ("Memcpy DtoH" in name and launch is not None
            and not al.in_run((launch[0] + launch[1]) / 2))


def joined_spans(profile: Profile, ops: List[tuple], al: Aligned
                 ) -> List[tuple]:
    """(name, us, node span or None, launch) of each device operation of
    the sub-window, its us counted as ``harness.device_spans`` counts
    them (a union on one stream), its node the node span that holds its
    launch's midpoint."""
    keyed = Profile(profile.t0, profile.t1,
                    [(a, b, (k, n, launch))
                     for n, (a, b, k, launch) in enumerate(ops)],
                    profile.host, profile.images)
    out = []
    for (name, _, launch), us in device_spans(keyed):
        node = (al.holding((launch[0] + launch[1]) / 2, "node")
                if launch is not None else None)
        out.append((name, us, node, launch))
    return out


def syncs_per_batch(al: Aligned) -> Optional[float]:
    """Synchronizing CUDA calls inside ``run`` spans (the recorder counts
    no other) per recorded batch."""
    runs = al.runs
    if not runs:
        return None
    return len(al.syncs) / len(runs)


def sync_events(profile: Profile, al: Aligned) -> List[tuple]:
    """The profile's host sync calls (``SYNC_CALLS``) whose midpoint lies
    inside a ``run`` span: not the harness's own waits for its copies."""
    return [h for h in profile.host if h[2] in SYNC_CALLS
            and al.in_run((h[0] + h[1]) / 2)]


def host_sync_ms(profile: Profile, al: Aligned) -> Optional[float]:
    """Host ms per recorded batch spent in sync calls inside ``run``
    spans."""
    runs = al.runs
    if not runs:
        return None
    return sum(b - a for a, b, _ in sync_events(profile, al)) / 1e3 / len(
        runs)


def op_us_per_image(joined: List[tuple], images: int, op: str
                    ) -> Optional[float]:
    """Device us per image in operations launched inside ``op`` node
    spans."""
    if not images:
        return None
    return sum(us for _, us, node, _ in joined
               if node is not None and node.op == op) / images


def gap_name(profile: Profile, al: Optional[Aligned], start: float,
             end: float) -> str:
    """``harness.host_doing``'s name of an idle gap, after the innermost
    program span at the gap's middle where one holds it: ``node <name>
    (<op>) / ...`` or ``run / ...``."""
    doing = host_doing(profile, start, end)
    span = al and al.innermost((start + end) / 2)
    if span is None:
        return doing
    where = "run" if span.kind == "run" else f"node {span.name} ({span.op})"
    return f"{where} / {doing}"


def named_gaps(profile: Profile, al: Optional[Aligned], top: int = 10
               ) -> List[list]:
    """The ``top`` longest idle gaps as ``harness.breakdown`` lists them
    (name, seconds), named by ``gap_name``."""
    gaps = sorted(idle_gaps(profile), key=lambda g: g[0] - g[1])[:top]
    return [[gap_name(profile, al, a, b)[:200], (b - a) / 1e6]
            for a, b in gaps]


def launch_share_in_nodes(profile: Profile, al: Aligned
                          ) -> Tuple[int, int]:
    """(launches inside a node span, launches inside a ``run`` span): the
    kernel launch events between a run span's start and end."""
    mids = [(h[0] + h[1]) / 2 for h in profile.host if is_launch(h[2])]
    in_run = [t for t in mids if al.in_run(t)]
    return sum(al.holding(t, "node") is not None for t in in_run), len(
        in_run)
