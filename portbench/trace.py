"""The traced run: ``torch.profiler`` over the window, the arguments of
the port's hand kernels, and what both reduce to.

The profiler records the host's spans (the harness's
``record_function`` around each fit's parts and one around the whole
window) and the device's activity (kernels, copies, sets). The entry
points of ``ultranest_torch.ops.kernels`` named by ``bounds/*.py`` are
wrapped for the window, so that each call's bound is worked out from
that call's arguments; a call made while a CUDA graph is captured is
booked as captured: every replay of the graph runs it with those
arguments.
"""

import bisect
import glob
import os
import re
import time

from .harness import BENCH_DIR, load_module

WINDOW_SPAN = 'window'


def load_bounds():
    """Every ``bounds/<entry>.py``, by entry point name."""
    out = {}
    for path in sorted(glob.glob(os.path.join(BENCH_DIR, 'bounds', '*.py'))):
        name = os.path.basename(path)[:-3]
        if name.startswith('_'):
            continue
        out[name] = load_module('bounds', name)
    return out


class KernelCalls:
    """Wraps the entry points of ``ultranest_torch.ops.kernels`` that have
    a bound; books each call made while :attr:`active`."""

    def __init__(self, bounds, on_card=True):
        import torch
        from ultranest_torch.ops import kernels
        self.torch, self.kernels, self.bounds = torch, kernels, bounds
        self.on_card = on_card
        self.active = False
        self.calls = {name: [] for name in bounds}
        self._orig = {}
        for name, mod in bounds.items():
            orig = self._orig[name] = getattr(kernels, mod.ENTRY)
            setattr(kernels, mod.ENTRY, self._wrap(name, mod, orig))

    def _wrap(self, name, mod, orig):
        def call(*args):
            out = orig(*args)
            if self.active:
                cap = self.on_card and \
                    self.torch.cuda.is_current_stream_capturing()
                self.calls[name].append((cap, mod.record(args, out, cap)))
            return out
        return call

    def restore(self):
        for name, mod in self.bounds.items():
            setattr(self.kernels, mod.ENTRY, self._orig[name])


class Trace:
    """What a traced window reduces to: the device's activity intervals,
    the host's spans, and each kernel entry's bound and device time."""

    def __init__(self, events, kernel_calls, bounds):
        from torch._C._autograd import DeviceType
        cpu = DeviceType.CPU
        dev, spans = [], []
        for ev in events:
            if ev.device_type() == cpu:
                if ev.is_user_annotation():
                    spans.append((ev.start_ns(), ev.end_ns(), ev.name()))
            elif not ev.is_user_annotation():
                # (a span's copy on the device's timeline is no work)
                dev.append((ev.start_ns(), ev.end_ns(), ev.name()))
        win = [s for s in spans if s[2] == WINDOW_SPAN]
        if win:
            self.t0, self.t1 = win[0][0], win[0][1]
        elif dev:
            self.t0 = min(d[0] for d in dev)
            self.t1 = max(d[1] for d in dev)
        else:
            self.t0 = self.t1 = 0
        self.device = [(max(a, self.t0), min(b, self.t1), n)
                       for a, b, n in dev if b > self.t0 and a < self.t1]
        self.device.sort(key=lambda e: e[0])
        self.spans = [s for s in spans if s[2] != WINDOW_SPAN]
        self.window_s = (self.t1 - self.t0) * 1e-9
        self.busy = union(self.device)
        self.busy_s = sum(b - a for a, b in self.busy) * 1e-9
        self.kernels = self._kernels(kernel_calls, bounds)

    def _kernels(self, kernel_calls, bounds):
        """Entry -> dict(bound_s, device_s, executions, launched,
        captured); bound_s is None where the calls and the device's
        executions cannot be matched."""
        out = {}
        if kernel_calls is None:
            return out
        # each distinct device name classified once
        count, secs = {}, {}
        for a, b, n in self.device:
            count[n] = count.get(n, 0) + 1
            secs[n] = secs.get(n, 0) + (b - a)
        for name, mod in bounds.items():
            pats = {k: re.compile(r'(?<![A-Za-z0-9_])%s(?![A-Za-z0-9_])' % k)
                    for k in mod.KERNELS}
            first = sum(c for n, c in count.items()
                        if any(pats[k].search(n) for k in mod.ONCE))
            dev_s = sum(t for n, t in secs.items()
                        if any(p.search(n) for p in pats.values())) * 1e-9
            calls = kernel_calls.calls[name]
            if not first and not calls:
                continue
            launched = [mod.bound_s(r) for cap, r in calls if not cap]
            captured = [mod.bound_s(r) for cap, r in calls if cap]
            n_graph = first - len(launched)
            bound = None
            if None not in launched and None not in captured:
                if n_graph == 0:
                    bound = sum(launched)
                elif n_graph > 0 and captured and \
                        max(captured) - min(captured) <= 1e-9 * max(captured):
                    bound = sum(launched) + n_graph * captured[0]
            out[name] = dict(bound_s=bound, device_s=dev_s, executions=first,
                             launched=len(launched), captured=len(captured))
        return out

    def device_ops(self, top=10):
        """The device operations with the most time, by name."""
        by_name = {}
        for a, b, n in self.device:
            by_name[n] = by_name.get(n, 0) + (b - a)
        tot = {}
        for n, t in by_name.items():
            k = short_name(n)
            tot[k] = tot.get(k, 0.0) + t * 1e-9
        return sorted(([k, v] for k, v in tot.items()),
                      key=lambda kv: -kv[1])[:top]

    def idle_gaps(self, top=10):
        """The device's idle time in the window, by the innermost host span
        the host was in ('between fits' outside any), split where a span
        begins or ends."""
        gaps, prev = [], self.t0
        for a, b in self.busy:
            if a > prev:
                gaps.append((prev, a))
            prev = max(prev, b)
        if self.t1 > prev:
            gaps.append((prev, self.t1))
        # elementary pieces between span boundaries, each with its span
        cuts = sorted({self.t0, self.t1} | {t for s in self.spans
                                            for t in s[:2]})
        names = []
        for a, b in zip(cuts[:-1], cuts[1:]):
            mid = (a + b) / 2
            inner = [s for s in self.spans if s[0] <= mid < s[1]]
            names.append(min(inner, key=lambda s: s[1] - s[0])[2]
                         if inner else 'between fits')
        tot = {}
        for a, b in gaps:
            i = max(bisect.bisect_right(cuts, a) - 1, 0)
            while i < len(names) and cuts[i] < b:
                piece = min(b, cuts[i + 1]) - max(a, cuts[i])
                if piece > 0:
                    tot[names[i]] = tot.get(names[i], 0.0) + piece * 1e-9
                i += 1
        return sorted(([k, v] for k, v in tot.items()),
                      key=lambda kv: -kv[1])[:top]


def union(intervals):
    """The union of [start, end) intervals (sorted or not), as a sorted
    list of disjoint (start, end)."""
    out = []
    for a, b, *_ in sorted(intervals, key=lambda e: e[0]):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def short_name(name):
    """A kernel's name without its return type, template arguments and
    parameters."""
    n = name.replace('(anonymous namespace)::', '').split('(')[0]
    n = re.sub(r'^void ', '', n)
    depth, out = 0, []
    for ch in n:
        if ch == '<':
            depth += 1
        elif ch == '>':
            depth -= 1
        elif depth == 0:
            out.append(ch)
    return ''.join(out).strip()[:120] or name[:120]


class Profiler:
    """``torch.profiler`` over a window, with the kernels' arguments."""

    def __init__(self, on_card=True):
        import torch
        self.torch, self.on_card = torch, on_card
        self.bounds = load_bounds()
        self.kernel_calls = KernelCalls(self.bounds, on_card)
        self.prof = None
        self.span = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.on_card:
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.kernel_calls.active = True
        self.span = self.torch.profiler.record_function(WINDOW_SPAN)
        self.span.__enter__()
        return self

    def __exit__(self, *exc):
        if self.on_card:
            self.torch.cuda.synchronize()
        self.span.__exit__(*exc)
        self.kernel_calls.active = False
        t0 = time.perf_counter()
        self.prof.__exit__(*exc)
        self.stop_s = time.perf_counter() - t0
        self.kernel_calls.restore()
        return False

    def result(self):
        """The window's :class:`Trace`."""
        t0 = time.perf_counter()
        events = self.prof.profiler.kineto_results.events()
        t1 = time.perf_counter()
        tr = Trace(events, self.kernel_calls, self.bounds)
        tr.reduce_s = dict(stop=self.stop_s, events=t1 - t0,
                           reduce=time.perf_counter() - t1,
                           count=len(events))
        return tr
