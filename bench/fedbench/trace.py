"""The traced window's device activity, from ``torch.profiler``'s raw
events: each card's busy time (the union of its kernels, copies and
sets), the device time of each kernel by name, and the idle gaps of the
first card named by the host operation that was running when the card
went idle."""
from __future__ import annotations

from collections import defaultdict

WINDOW = "bench.window"


def start():
    """A started profiler over the host and the cards."""
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    return prof


def _merge(spans: list) -> list:
    spans.sort()
    out = []
    for a, b in spans:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _innermost(cpu: list, points: list) -> list:
    """For each time in ``points`` (sorted), the name of the innermost
    host event of ``cpu`` (``(start, end, name)`` sorted by start, properly
    nested) that covers it, or ``"host: no operation"``."""
    names, stack, i = [], [], 0
    for p in points:
        while i < len(cpu) and cpu[i][0] <= p:
            while stack and stack[-1][1] <= cpu[i][0]:
                stack.pop()
            stack.append(cpu[i])
            i += 1
        while stack and stack[-1][1] <= p:
            stack.pop()
        names.append(stack[-1][2] if stack else "host: no operation")
    return names


def reduce(prof, devices: list) -> dict:
    """``{"window_s", "busy_s" {card: s}, "kernels" {name: s},
    "device_events" [(name, card, start_ns, end_ns)], "idle_gaps" {host
    op: s}}`` over the ``bench.window`` annotation's span."""
    from torch.autograd import DeviceType
    raw = prof.profiler.kineto_results.events()
    win = [e for e in raw if e.name() == WINDOW
           and e.device_type() == DeviceType.CPU]
    if not win:
        return {}
    w = win[0]
    w0, w1, tid = w.start_ns(), w.start_ns() + w.duration_ns(), \
        w.start_thread_id()
    dev, cpu = [], []
    for e in raw:
        a = e.start_ns()
        b = a + e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            if e.is_user_annotation() or e.name().startswith("bench."):
                continue
            if b > w0 and a < w1:
                dev.append((e.name(), e.device_index(), max(a, w0),
                            min(b, w1)))
        elif (e.start_thread_id() == tid and not e.is_async()
              and e.name() != WINDOW and b > w0 and a < w1):
            cpu.append((a, b, e.name()))
    busy, kernels = {}, defaultdict(float)
    per_dev = defaultdict(list)
    for name, d, a, b in dev:
        per_dev[d].append((a, b))
        kernels[name] += (b - a) * 1e-9
    merged = {d: _merge(s) for d, s in per_dev.items()}
    for d in devices:
        busy[d] = sum(b - a for a, b in merged.get(d, [])) * 1e-9
    gaps, edge = [], w0
    for a, b in merged.get(devices[0], []):
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    if w1 > edge:
        gaps.append((edge, w1))
    cpu.sort()
    idle = defaultdict(float)
    for (a, b), name in zip(gaps, _innermost(cpu, [g[0] for g in gaps])):
        idle[name] += (b - a) * 1e-9
    return {"window_s": (w1 - w0) * 1e-9, "busy_s": busy,
            "kernels": dict(kernels), "device_events": dev,
            "idle_gaps": dict(idle)}


def top(d: dict, n: int = 10, width: int = 120) -> list:
    """The ``n`` largest entries of ``{name: seconds}`` as ``[[name, s]]``."""
    return [[k[:width], v] for k, v in
            sorted(d.items(), key=lambda kv: kv[1], reverse=True)[:n]]


