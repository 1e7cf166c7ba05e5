"""Where one proving run's time goes on the card.

    python -m zkdl_tpu_torch.profile_prove [--trace DIR]   # BENCH_CONFIG=zkdl256 (default)

Builds the bench configuration, warms up, then profiles one steady proving
run, in the configuration's Fiat-Shamir schedule, with torch.profiler (CPU
and CUDA activity, ``utils/profiling.trace``; --trace also writes the
run's Chrome trace to DIR/trace.json). Everything is read from that
one profiled run: its wall time, the device time (kernels and copies summed;
one stream, so they never overlap), the device's busy share over the span
from the first kernel's start to the last kernel's end and over the run's
wall, the count of kernel launches, and device time by kernel: the 20
largest, and the hand-written kernels (K1-K6) apart from PyTorch's own
wherever they rank. The profiler slows the
host, not the kernels, so the busy share under it is a lower bound of the
unprofiled one. The unprofiled steady wall of bench.run is printed beside it
for reference only. The last line is the same record as JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from . import bench
from .utils import profiling

# hand-written kernels, by the device function names in csrc/
OURS = {
    "fr_mul_kernel": "K1 fr_mul",
    "fr_mul_scalar_kernel": "K2 fr_mul_scalar",
    "fr_dot_kernel": "K3 fr_dot",
    "g1_comb_kernel": "K4 g1_comb",
    "g1_scalar_mul_kernel": "K5 g1_scalar_mul",
    "g1_add_kernel": "K6 g1_add",
    "g1_glv_kernel": "K8 g1_scalar_mul_glv",
}


def _group(name: str) -> str:
    for key, label in OURS.items():
        if key in name:
            return label
    return "pytorch: " + name.split("(")[0].strip()[:80]


def device_time(prof) -> tuple[dict[str, list], float, float]:
    """Device-side events of a finished profile (kernels, copies; CPU op
    events carry their kernels' time as their own device time) grouped by
    _group: {group: [seconds, launches]}, and the first start and last end
    (us)."""
    groups: dict[str, list] = {}
    first, last = float("inf"), 0.0
    for ev in prof.events():
        dur = ev.time_range.elapsed_us()
        if ev.device_type != torch.autograd.DeviceType.CUDA or dur <= 0:
            continue
        g = groups.setdefault(_group(ev.name), [0.0, 0])
        g[0] += dur / 1e6
        g[1] += 1
        first, last = min(first, ev.time_range.start), max(last, ev.time_range.end)
    return groups, first, last


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--trace", metavar="DIR", help="also write the profiled run's Chrome trace to DIR")
    args = parser.parse_args(argv)
    config = os.environ.get("BENCH_CONFIG", "zkdl256")
    res = bench.run(config, split=False, verify=False)
    model, X, dev = res["model"], res["X"], res["X"].device
    Y, Z, A, aux = model.infer(X)
    torch.cuda.synchronize(dev)
    with profiling.trace(args.trace) as prof:
        t0 = time.perf_counter()
        model.prove(X, Y, Z, A, aux, interleave=res["interleave"], commit_aux=res["commit_aux"])
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    groups, first, last = device_time(prof)
    busy = sum(g[0] for g in groups.values())
    span = (last - first) / 1e6
    launches = sum(g[1] for g in groups.values())
    ranked = sorted(groups.items(), key=lambda kv: -kv[1][0])
    # the 20 largest, and every hand-written kernel wherever it ranks
    shown = [kv for i, kv in enumerate(ranked) if i < 20 or not kv[0].startswith("pytorch")]
    steady = res["prove_s"]
    print(f"{config}: profiled prove wall {wall:.3f}s, device busy {busy:.3f}s = "
          f"{100 * busy / span:.1f}% of the {span:.3f}s kernel span, {100 * busy / wall:.1f}% of the wall; "
          f"{launches} kernel launches (unprofiled steady prove of the same model: {steady:.3f}s)")
    for name, (secs, count) in shown:
        print(f"  {secs * 1e3:10.2f} ms  {count:7d} launches  {name}")
    ours = sum(g[0] for n, g in groups.items() if not n.startswith("pytorch"))
    print(json.dumps({
        "config": config, "device": torch.cuda.get_device_name(dev), "profiled_wall_s": wall,
        "kernel_span_s": span, "device_busy_s": busy, "busy_share": busy / span,
        "busy_share_of_wall": busy / wall, "unprofiled_steady_wall_s": steady,
        "kernel_launches": launches,
        "handwritten_kernel_s": ours,
        "by_kernel": {n: {"s": s, "launches": c} for n, (s, c) in shown},
    }))


if __name__ == "__main__":
    main()
