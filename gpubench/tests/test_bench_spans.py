"""The program's spans on a profile's clock (``spans.py``), on a synthetic
profile and recording: the anchor's conversion, the sync readings that
leave out the harness's own waits, the join of kernels to ``Eltwise``
node spans by correlation id, and idle gaps named by the span that holds
them (and named as before with no recording)."""

from collections import namedtuple
from types import SimpleNamespace

import pytest

import spans
from harness import Profile, host_doing

Span = namedtuple("Span", "id parent batch kind name op t0_ns t1_ns")
Sync = namedtuple("Sync", "t_ns batch node op site")

# host ns = (profile us - 105) * 1e3 + 1_002_000: the narrowest bracket's
# midpoint and its sync event's (the second); the first pays for set-up
ANCHOR = [(-500_000, 100_000), (1_000_000, 1_004_000)]


def ns(us: float) -> int:
    return int(round((us - 105.0) * 1e3 + 1_002_000))


def recording():
    """One batch: a run over [200, 400] us, a conv node over [210, 285]
    and an Eltwise node over [300, 390]; one sync inside the Eltwise."""
    return SimpleNamespace(
        spans=[Span(0, None, 0, "run", "run", "", ns(200), ns(400)),
               Span(1, 0, 0, "node", "res2a", "Convolution", ns(210),
                    ns(285)),
               Span(2, 0, 0, "node", "res2a_add", "Eltwise", ns(300),
                    ns(390))],
        syncs=[Sync(ns(350), 0, "res2a_add", "Eltwise", "lowering.py:1")],
        anchor_ns=ANCHOR)


def profile():
    """The anchor's sync, a launch in each node and one in the run between
    nodes, the program's stream sync, the harness's copy-out and its wait
    for it after the run."""
    host = [(-400.0, 100.0, "cudaDeviceSynchronize"),
            (100.0, 110.0, "cudaDeviceSynchronize"),
            (220.0, 222.0, "cudaLaunchKernel"),
            (310.0, 312.0, "cudaLaunchKernel"),
            (295.0, 296.0, "cudaLaunchKernel"),
            (340.0, 380.0, "cudaStreamSynchronize"),
            (401.0, 402.0, "cudaMemcpyAsync"),
            (410.0, 450.0, "cudaEventSynchronize")]
    device = [(230.0, 280.0, "wgemm_kernel"),
              (315.0, 335.0, "at::native::add_kernel"),
              (300.0, 301.0, "at::native::cast_kernel"),
              (405.0, 409.0, "Memcpy DtoH (Device -> Pinned)")]
    return Profile(230.0, 409.0, device, host, images=4)


class Event(SimpleNamespace):
    pass


def raw_profiler():
    """A ``torch.profiler.profile`` stand-in: the profile's events with
    correlation ids (kernel i launched by runtime event 10 + i)."""
    p = profile()
    launch_ids = {2: 10, 3: 11, 4: 12, 6: 13}
    events = []
    for i, (a, b, k) in enumerate(p.host):
        events.append(Event(time_range=SimpleNamespace(start=a, end=b), key=k,
                            id=launch_ids.get(i, 0), device_type="CPU",
                            is_user_annotation=False))
    for i, (a, b, k) in enumerate(p.device):
        events.append(Event(time_range=SimpleNamespace(start=a, end=b), key=k,
                            id=10 + i, device_type="DeviceType.CUDA",
                            is_user_annotation=False))
    events.append(Event(time_range=SimpleNamespace(start=210.0, end=290.0),
                        key="res2a", id=0, device_type="DeviceType.CUDA",
                        is_user_annotation=True))
    return SimpleNamespace(events=lambda: events)


def test_the_anchor_puts_spans_on_the_profiles_clock():
    al = spans.aligned(recording(), profile())
    assert al.bracket_us == 4.0
    assert [(a, b, s.name) for a, b, s in al.spans] == [
        (200.0, 400.0, "run"), (210.0, 285.0, "res2a"),
        (300.0, 390.0, "res2a_add")]
    assert al.syncs[0][0] == 350.0
    assert al.innermost(250.0).name == "res2a"
    assert al.innermost(295.0).kind == "run"
    assert al.innermost(405.0) is None
    # no anchor, or a sync event short: nothing to align
    assert spans.aligned(SimpleNamespace(**{**vars(recording()),
                                            "anchor_ns": []}),
                         profile()) is None
    p = profile()
    p.host = p.host[1:]
    assert spans.aligned(recording(), p) is None


def test_syncs_outside_runs_are_not_counted():
    p, al = profile(), spans.aligned(recording(), profile())
    assert spans.syncs_per_batch(al) == 1.0
    # the stream sync inside the run (40 us), not the harness's event wait
    assert [h[2] for h in spans.sync_events(p, al)] == [
        "cudaStreamSynchronize"]
    assert spans.host_sync_ms(p, al) == pytest.approx(0.040)
    assert spans.launch_share_in_nodes(p, al) == (2, 3)


def test_only_kernels_launched_in_eltwise_spans_count():
    p, al = profile(), spans.aligned(recording(), profile())
    ops = spans.correlated(raw_profiler())
    assert len(ops) == len(p.device)      # the annotation left out
    joined = spans.joined_spans(p, ops, al)
    by_name = {name: (us, node and node.name) for name, us, node, _ in joined}
    assert by_name == {
        "wgemm_kernel": (50.0, "res2a"),
        "at::native::add_kernel": (20.0, "res2a_add"),
        "at::native::cast_kernel": (1.0, None),   # launched between nodes
        "Memcpy DtoH (Device -> Pinned)": (4.0, None)}
    assert spans.op_us_per_image(joined, p.images, "Eltwise") == 5.0
    copy = [(name, launch) for name, _, _, launch in joined
            if name.startswith("Memcpy")]
    assert [spans.is_copy_out(name, launch, al) for name, launch in copy] \
        == [True]
    assert not spans.is_copy_out("at::native::add_kernel",
                                 (310.0, 312.0, "cudaLaunchKernel"), al)


def test_idle_gaps_take_the_span_that_holds_them():
    p, al = profile(), spans.aligned(recording(), profile())
    # idle 335-405 us: its middle, 370, lies in the Eltwise node and its
    # stream sync; 280-300: 290 in the run between nodes; 301-315: 308 in
    # the Eltwise node, the host in Python before its launch
    gaps = [(335.0, 405.0), (280.0, 300.0), (301.0, 315.0)]
    want = ["node res2a_add (Eltwise) / cudaStreamSynchronize",
            "run / host Python, then at::native::cast_kernel",
            "node res2a_add (Eltwise) / host Python, then "
            "at::native::add_kernel"]
    assert [spans.gap_name(p, al, a, b) for a, b in gaps] == want
    assert [n for n, _ in spans.named_gaps(p, al)] == want
    # with no recording, the harness's names as they are
    assert [n for n, _ in spans.named_gaps(p, None)] == [
        host_doing(p, a, b) for a, b in gaps]
    assert [n.split(" / ")[1] for n in want] == [
        host_doing(p, a, b) for a, b in gaps]
