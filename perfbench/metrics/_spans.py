"""Shared by the readers of the port's spans (cm3d_tpu_torch/utils/
observability.py) in the traced part with the host's ranges.

The dispatch thread is the one that ran `cm3d.lift.step`. The traced
window is cut where the `cm3d.` spans open on that thread begin and end
(the harness's ranges and the aten ops are skipped; spans cut by the
window's edges are clipped to it), and each piece goes to its innermost
span. The device's idle time (the gaps between its merged kernels, copies
and fills inside the window) falls on those pieces, and by the port's
naming (observability's docstring) is: `io` under `cm3d.e2e.io.wait` (the
wait for the IO thread's next frame), `sync` under another `.wait` span,
`dispatch` under any other `cm3d.` span (the host still queuing work), and
`unattributed` under none (the harness's own code between calls into the
port). The four add up to the window's idle time. A program without the
port's spans reads nothing (None).
"""

from collections import defaultdict

PREFIX = "cm3d."
STEP = "cm3d.lift.step"
IO_WAIT = "cm3d.e2e.io.wait"


def kind(name) -> str:
    if name is None:
        return "unattributed"
    if name == IO_WAIT:
        return "io"
    return "sync" if name.endswith(".wait") else "dispatch"


def dispatch_tid(trace):
    """The thread that ran the lift step (the most of its spans), or None."""
    count = defaultdict(int)
    for tid, _, _ in trace.ranges.get(STEP, ()):
        count[tid] += 1
    return max(count, key=count.get) if count else None


def segments(trace, tid) -> list:
    """[(start, end, innermost `cm3d.` span name or None)], in order,
    covering the window [t0, t1] (microseconds)."""
    spans = sorted(((a, b, name) for name, items in trace.ranges.items()
                    if name.startswith(PREFIX) for t, a, b in items if t == tid),
                   key=lambda s: (s[0], -s[1]))
    out, stack, cur = [], [], trace.t0

    def cut(at):
        nonlocal cur
        at = min(max(at, trace.t0), trace.t1)
        if at > cur:
            out.append((cur, at, stack[-1][2] if stack else None))
            cur = at

    for a, b, name in spans:
        while stack and stack[-1][1] <= a:
            cut(stack[-1][1])
            stack.pop()
        cut(a)
        stack.append((a, b, name))
    while stack:
        cut(stack[-1][1])
        stack.pop()
    cut(trace.t1)
    return out


def idle_gaps(trace) -> list:
    """[(start, end)] of the window in which nothing ran on the device."""
    edges = [trace.t0] + [x for iv in trace._busy() for x in iv] + [trace.t1]
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
            if edges[i + 1] > edges[i]]


def split(ctx):
    """Seconds of the traced window: idle time by kind (`dispatch`, `sync`,
    `io`, `unattributed`), their sum `idle`, and `host`, the dispatch
    thread's self time in non-wait spans; None without the port's spans."""
    if "_spans" not in ctx:
        trace = ctx["trace"]
        tid = dispatch_tid(trace)
        if tid is None:
            ctx["_spans"] = None
            return None
        segs = segments(trace, tid)
        out = dict.fromkeys(("dispatch", "sync", "io", "unattributed", "host"), 0.0)
        for a, b, name in segs:
            if kind(name) == "dispatch":
                out["host"] += b - a
        gaps, i, j = idle_gaps(trace), 0, 0
        while i < len(segs) and j < len(gaps):
            a, b = max(segs[i][0], gaps[j][0]), min(segs[i][1], gaps[j][1])
            if b > a:
                out[kind(segs[i][2])] += b - a
            if segs[i][1] < gaps[j][1]:
                i += 1
            else:
                j += 1
        out["idle"] = sum(b - a for a, b in gaps)
        ctx["_spans"] = {k: v * 1e-6 for k, v in out.items()}
    return ctx["_spans"]


def ms_per_kf(ctx, key: str):
    """`key` of `split`, in milliseconds a traced keyframe."""
    frames = ctx["probe"].traced.get("frames")
    parts = split(ctx)
    if not frames or parts is None:
        return None
    return 1e3 * parts[key] / frames
