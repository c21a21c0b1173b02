"""What a span of the port's recorder (sbb_textline_detection_tpu_torch/
utils/profiling.py) costs the host, and how far it lies from
torch.profiler's record of the same interval.

    python3 scripts/span_probe.py [--device cuda] [--json OUT]

Prints one JSON object:
  * `ns_per_span`: one `with profiling.span(...)` with a page's list in
    use, and with none (the stamps alone), over 200,000 spans;
  * `fetch_ns`: profiling.fetch against a bare `.cpu().numpy()` of a
    one-element tensor, and the difference (the fetch span's own cost);
  * `offset_ms`: under torch.profiler (CPU, and CUDA on a card), a span
    and a record_function opened at the same point around a small
    device op, 50 times: the median and largest gap of their starts and
    of their ends;
  * `annotation_on_card`: the device type the profiler gives the
    record_function's range on a card (why the program opens none).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from sbb_textline_detection_tpu_torch.utils import profiling  # noqa: E402


def per_span_ns(n: int, bound: bool) -> float:
    spans: list = []
    best = float("inf")
    for _ in range(3):
        spans.clear()
        t = time.perf_counter_ns()
        if bound:
            with profiling.record_into(spans, "probe"):
                for _ in range(n):
                    with profiling.span("x"):
                        pass
        else:
            for _ in range(n):
                with profiling.span("x"):
                    pass
        best = min(best, (time.perf_counter_ns() - t) / n)
    return best


def fetch_ns(device: str, n: int = 20000) -> dict:
    t = torch.ones(1, device=device)
    spans: list = []
    out = {}
    with profiling.record_into(spans, "probe"):
        for name, fn in (("bare", lambda: t.cpu().numpy()),
                         ("fetch", lambda: profiling.fetch(t)),
                         ("bare_again", lambda: t.cpu().numpy())):
            for _ in range(100):
                fn()
            spans.clear()
            s = time.perf_counter_ns()
            for _ in range(n):
                fn()
            out[name] = (time.perf_counter_ns() - s) / n
    out["span_cost"] = out["fetch"] - 0.5 * (out["bare"] + out["bare_again"])
    return out


def offsets(device: str, n: int = 50) -> dict:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.startswith("cuda"):
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    x = torch.ones(256, 256, device=device)
    spans: list = []
    with torch.profiler.profile(activities=acts) as prof:
        with profiling.record_into(spans, "probe"):
            for i in range(n):
                with profiling.span("probe"), \
                        torch.profiler.record_function(f"probe_rf_{i}"):
                    (x @ x).sum().item()
    host, kinds = {}, set()
    for ev in prof.profiler.kineto_results.events():
        if ev.name().startswith("probe_rf_"):
            if str(ev.device_type()).endswith("CPU"):
                host[ev.name()] = (ev.start_ns(),
                                   ev.start_ns() + ev.duration_ns())
            else:
                kinds.add(str(ev.device_type()))
    starts, ends = [], []
    for i, sp in enumerate(spans):
        s, e = host[f"probe_rf_{i}"]
        starts.append((s - sp.start_ns) / 1e6)
        ends.append((sp.end_ns - e) / 1e6)
    return {"start_median": statistics.median(starts),
            "start_max": max(starts, key=abs),
            "end_median": statistics.median(ends),
            "end_max": max(ends, key=abs),
            "first_start": starts[0],
            "annotation_on_card": sorted(kinds)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    out = {"torch": torch.__version__,
           "device": (torch.cuda.get_device_name() if args.device.startswith(
               "cuda") else "cpu"),
           "ns_per_span": {"recorded": per_span_ns(200000, True),
                           "unrecorded": per_span_ns(200000, False)},
           "fetch_ns": fetch_ns(args.device),
           "offset_ms": offsets(args.device)}
    print(json.dumps(out), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
