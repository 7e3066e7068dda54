"""What the device did during a traced sub-window, from ``torch.profiler``
(CUPTI device records and the host's CUDA runtime calls).

The profiler matches each device record to the host call that issued it
by correlation id, and keeps only records its clock places inside its
window; on a loaded host that clock can be off and records go missing.
``lost_launches`` counts the kernel launches issued on the host without
a device record (the accounting of the port's ``chip_smoke.py``
``lost_device_records``), and the roofline is taken only over launches
that have one. Host-to-device bytes come from the profile's Chrome
trace, the one record that carries them on torch 2.11 (its events'
``metadata_json`` is empty and ``nbytes`` 0 there): it is written to one
temporary file under ``TMPDIR`` and deleted once read.

Host and device times are on the profiler's clock (Unix nanoseconds);
the benchmark's spans (``time.perf_counter``) are moved onto it by one
offset read when the profile starts.
"""
from __future__ import annotations

import bisect
import json
import os
import re
import tempfile
import time
from collections import Counter
from typing import Dict, List, Optional

from .spans import SYNC_SPANS, union_seconds

HOST_LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel")
HOST_ISSUES = HOST_LAUNCHES + ("cudaMemcpy", "cuMemcpy", "cudaMemset",
                               "cuMemset")
TOP = 10


def short_name(name: str) -> str:
    name = name.replace("(anonymous namespace)::", "")
    return re.split(r"[(<]", name)[0].strip()[-64:]


class DeviceProfile:
    """One profiled sub-window: ``start()``, the work, ``stop()``."""

    def __init__(self, torch) -> None:
        self.torch = torch
        self.prof = None
        self.offset_ns = 0.0
        self.t0 = self.t1 = 0.0

    def prime(self) -> None:
        """Start and stop the profiler once on a small copy: its first
        start initialises CUPTI, which blocks the host for seconds (run
        in set-up, not in the window)."""
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]):
            self.torch.ones(1024, device="cuda").cpu()
        self.torch.cuda.synchronize()

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        self.offset_ns = time.time_ns() - time.perf_counter() * 1e9
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        self.torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.stop()

    def ns(self, t_perf: float) -> float:
        return t_perf * 1e9 + self.offset_ns

    def read(self, launches: List[dict], spans: Dict[str, list],
             kernels: Dict[str, object]) -> dict:
        """Device records of the sub-window: busy seconds, device time by
        kernel, host-to-device bytes, the longest idle gaps (each named
        by the benchmark's innermost synchronous span open on the host
        in its middle), the lost launches, and each recorded kernel
        launch of ``launches`` (in the sub-window) with its device
        nanoseconds."""
        torch = self.torch
        lo, hi = self.ns(self.t0), self.ns(self.t1)
        device, host = [], []
        for ev in self.prof.profiler.kineto_results.events():
            if ev.device_type() == torch.autograd.DeviceType.CUDA:
                device.append((ev.start_ns(), ev.start_ns()
                               + ev.duration_ns(), ev.correlation_id(),
                               ev.name()))
            elif ev.name().startswith(HOST_ISSUES):
                host.append((ev.start_ns(), ev.name(), ev.correlation_id()))
        host.sort()
        by_corr = {c: (a, b, name) for a, b, c, name in device}
        host_launches = [(t, c) for t, name, c in host
                         if name.startswith(HOST_LAUNCHES)]
        times = [t for t, _ in host_launches]
        lost_calls = Counter(name for _, name, c in host if c not in by_corr)
        busy = [(max(a, lo), min(b, hi)) for a, b, *_ in device
                if b > lo and a < hi]
        busy_s = union_seconds(busy, lo, hi) / 1e9
        by_name: Counter = Counter()
        for a, b, _, name in device:
            by_name[short_name(name)] += (b - a) / 1e9
        h2d = (self._h2d_from_trace()
               if any("HtoD" in d[3] for d in device) else 0)

        recorded, lost_kernel = [], 0
        for rec in launches:
            if not (self.t0 <= rec["t0"] and rec["t1"] <= self.t1):
                continue
            i = bisect.bisect_left(times, self.ns(rec["t0"]))
            j = bisect.bisect_right(times, self.ns(rec["t1"]))
            name = kernels[rec["kernel"]].DEVICE_NAME
            found = [by_corr[c] for _, c in host_launches[i:j]
                     if c in by_corr and name in by_corr[c][2]]
            if not found:
                lost_kernel += 1
                continue
            recorded.append(dict(rec, device_ns=sum(y - x for x, y, _
                                                    in found)))

        gaps = self._gaps(busy, lo, hi, spans)
        return dict(busy_s=busy_s, window_s=(hi - lo) / 1e9,
                    device_ops=[[k, v] for k, v in by_name.most_common(TOP)],
                    idle_gaps=gaps[:TOP], h2d_bytes=h2d,
                    launches=recorded, lost_kernel_launches=lost_kernel,
                    host_launches=len(host_launches),
                    lost_host_calls=dict(lost_calls),
                    device_records=len(device))

    def _h2d_from_trace(self) -> int:
        """Host-to-device copy bytes from the profile's Chrome trace (its
        copy records carry ``args.bytes``), written to the temporary
        directory and deleted."""
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.unlink(path)
        return sum(int(e.get("args", {}).get("bytes", 0)) for e in events
                   if e.get("cat") in ("gpu_memcpy", "Memcpy")
                   and "HtoD" in e.get("name", ""))

    def _gaps(self, busy, lo, hi, spans) -> List[list]:
        gaps, end = [], lo
        for a, b in sorted(busy) + [(hi, hi)]:
            if a > end:
                gaps.append((a - end, end, a))
            end = max(end, b)
        gaps.sort(reverse=True)
        out = []
        for length, a, b in gaps[:TOP]:
            mid = (a + b) / 2
            label = "loop"
            for name in SYNC_SPANS:
                if any(self.ns(x) <= mid <= self.ns(y)
                       for x, y in spans.get(name, ())):
                    label = name
                    break
            out.append([label, length / 1e9])
        return out


def summary_line(p: Optional[dict]) -> str:
    if p is None:
        return "no profile"
    return json.dumps({k: p[k] for k in ("busy_s", "window_s",
                                         "lost_kernel_launches",
                                         "host_launches", "lost_host_calls",
                                         "device_records", "h2d_bytes")})
