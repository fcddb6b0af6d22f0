"""Reading a ``torch.profiler`` Chrome trace: the device's busy intervals, its kernels by
name, the idle gaps labelled by the host operation that ran through them."""
from __future__ import annotations

import bisect
import glob
import json
import os
import re
from collections import defaultdict
from dataclasses import dataclass

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_IDENT = re.compile(r"[A-Za-z_][A-Za-z0-9_]*")


def kernel_name(name: str) -> str:
    """The kernel's identifier: its name without ``void``, namespaces, template
    arguments and parameters."""
    head = name.replace("(anonymous namespace)", "").split("(")[0].split("<")[0]
    idents = [i for i in _IDENT.findall(head) if i != "void"]
    return idents[-1] if idents else name


@dataclass
class Trace:
    device: list  # (start_us, end_us, name) of kernels, copies and sets, by start
    host: list  # (start_us, end_us, name) of the host's operators, by start
    span: tuple  # (first start, last end) of every event, us

    @property
    def window_s(self) -> float:
        return (self.span[1] - self.span[0]) / 1e6

    def busy_intervals(self, match=None) -> list:
        """The union of the device intervals (of the kernels ``match`` accepts)."""
        out = []
        for s, e, name in self.device:
            if match is not None and not match(name):
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def busy_s(self, match=None) -> float:
        return sum(e - s for s, e in self.busy_intervals(match)) / 1e6

    def device_ops(self, top=10) -> list:
        totals = defaultdict(float)
        for s, e, name in self.device:
            totals[kernel_name(name)] += (e - s) / 1e6
        return sorted(totals.items(), key=lambda kv: -kv[1])[:top]

    def idle_gaps(self, top=10) -> list:
        """Idle device time by the innermost host operation running at each gap's
        middle."""
        starts = [h[0] for h in self.host]
        totals = defaultdict(float)
        edges = [self.span[0]] + [t for iv in self.busy_intervals() for t in iv] + [self.span[1]]
        for s, e in zip(edges[::2], edges[1::2]):
            if e <= s:
                continue
            mid, label, best = (s + e) / 2, "no host operation", None
            i = bisect.bisect_right(starts, mid)
            for hs, he, name in self.host[max(0, i - 400):i][::-1]:
                if he >= mid and (best is None or he - hs < best):
                    label, best = name, he - hs
            totals[label] += (e - s) / 1e6
        return sorted(totals.items(), key=lambda kv: -kv[1])[:top]


def load(path: str) -> Trace:
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    device, host, lo, hi = [], [], float("inf"), float("-inf")
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        s = float(ev["ts"])
        e = s + float(ev["dur"])
        lo, hi = min(lo, s), max(hi, e)
        cat = ev.get("cat", "")
        if cat in DEVICE_CATS:
            device.append((s, e, ev.get("name", "")))
        elif cat == "cpu_op":
            host.append((s, e, ev.get("name", "")))
    device.sort()
    host.sort()
    return Trace(device, host, (lo, hi))


def load_dir(directory: str) -> Trace | None:
    """The one trace a run wrote under ``directory``, or None."""
    paths = sorted(glob.glob(os.path.join(directory, "*.json")))
    return load(paths[-1]) if paths else None
