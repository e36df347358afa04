"""Device time of the table-gradient kernel at the bench's plans.

    python -m subgnn_tpu_torch.kernel_times [--seed 0] [--against DIR]

On one CUDA device, for each of the bench's four plans (bf16 B=1280 and
fp32 B=512, neigh and cc; subgnn_tpu_torch/bench.py:bench_batch) it prints
one JSON line: `segment_matmul`'s device_ms, span_ms and call_ms, the
device time of each of its device activities, `index_add_`'s device_ms and
call_ms, the plain version's time (`plain_ms`, CUDA events around 3 calls)
and the byte bound. The card's name and power limit go first.

  device_ms  sum of the call's own device activities (kernels, memsets),
             the L2 flushed before the call; median over 20 traced calls
  span_ms    first start to last end of those activities, so the gaps
             between one call's launches count
  call_ms    CUDA events around 50 back-to-back eager calls, per call: the
             larger of the host's enqueue time and the device time, which
             is what a host-bound training step pays; the median of 5 such
             loops in each turn, since the host's share swings between loops

`--against DIR` also times the `segment_matmul` of another checkout in DIR
(for example the parent commit unpacked with `git archive`), built from
DIR's own source into DIR's own build directory, on the same inputs and in
turns: DIR, this, this, DIR.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import statistics
import sys
from pathlib import Path

import torch

from .bench import bench_batch, card
from .device import resolve_device
from .ops import embedding as E
from .train.plans import neigh_ids_for_batch

FLUSH_BYTES = 256 << 20     # copied before each traced call: > 5x the L2
TRACED_CALLS = 20
TRACE_TRIES = 3
EAGER_CALLS = 50
EAGER_LOOPS = 5
PEAK_HBM_BYTES = 3.35e12    # H100 SXM HBM3 (NVIDIA data sheet)


def event_ms(fn, iters: int) -> float:
    """CUDA-event time per call of `iters` back-to-back calls, after one."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _traced_calls(fn, calls: int, src, dst) -> list:
    """One torch.profiler trace of `calls` flushed calls of `fn`: each
    call's device activities, cut at the flush copies. One more call runs
    first, so a trace that misses its first copy still holds them all."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls + 1):
            dst.copy_(src)
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
    acts = sorted((e for e in prof.events()
                   if e.device_type == DeviceType.CUDA),
                  key=lambda e: e.time_range.start)
    per_call: list = []
    for e in acts:
        if "DtoD" in e.name:
            per_call.append([])
        elif per_call:
            per_call[-1].append(e)
    return per_call[-calls:]


def device_times(fn, calls: int = TRACED_CALLS) -> dict:
    """Trace `calls` calls of `fn` with torch.profiler, each after a
    device-to-device copy of FLUSH_BYTES that evicts the L2 and leaves it
    full of dirty lines, as the step's own earlier kernels would. The
    device timeline is cut at the copies (`fn` must make
    none of its own): a call's device activities are those after the last
    copy before it. A trace that lost activities (the profiler drops some
    now and then, the first copy most often) is taken again, up to
    TRACE_TRIES times. Returns {"device_ms", "span_ms", "activities":
    {name: ms per call}} (medians over the calls; activities are means)."""
    src = torch.empty(FLUSH_BYTES // 4, dtype=torch.int32, device="cuda")
    dst = torch.empty_like(src)
    fn()
    torch.cuda.synchronize()
    for _ in range(TRACE_TRIES):
        per_call = _traced_calls(fn, calls, src, dst)
        if len(per_call) == calls and all(per_call):
            break
    else:
        raise RuntimeError(f"device_times: {len(per_call)} flushes traced for "
                           f"{calls} calls, activities per call "
                           f"{sorted({len(a) for a in per_call})}")
    device_ms = [sum(e.time_range.elapsed_us() for e in a) / 1e3
                 for a in per_call]
    span_ms = [(max(e.time_range.end for e in a)
                - min(e.time_range.start for e in a)) / 1e3
               for a in per_call]
    activities: dict = {}
    for a in per_call:
        for e in a:
            activities[e.name] = (activities.get(e.name, 0.0)
                                  + e.time_range.elapsed_us() / 1e3 / calls)
    return {"device_ms": statistics.median(device_ms),
            "span_ms": statistics.median(span_ms),
            "activities": activities}


def bench_plans(batch, anchors):
    """[(name, ids, plan)] of the bench batch's two gather plans: the
    neighborhood anchors' (ids laid out as the plan's) and the CC ids'."""
    host = {k: anchors[k].cpu().numpy() for k in ("neigh_int", "neigh_bor")}
    neigh = torch.as_tensor(neigh_ids_for_batch(
        host, batch["subgraph_idx"].cpu().numpy()),
        device=batch["cc_ids"].device)
    return [("neigh", neigh, batch["neigh_plan"]),
            ("cc", batch["cc_ids"], batch["cc_plan"])]


def segment_bound_ms(g, plan, rows: int) -> float:
    """Least time of the table gradient on the card, by bytes: every
    slot's `local` and every tile's `block` read once, `pos` and the
    cotangent row of the real slots only (padding slots are skipped by
    `local`), the output written once (one fp32 add per element read is
    1/16 of that time at 67 TFLOP/s, so bytes bound it)."""
    n_real = int((plan.local < E.TABLE_BLOCK).sum())
    T, W = plan.pos.shape
    D, size = g.shape[1], g.element_size()
    n_bytes = (n_real * (D * size + 4) + T * W * 4 + T * 4
               + rows * D * size)
    return n_bytes / PEAK_HBM_BYTES * 1e3


def other_embedding(root: Path):
    """The ops.embedding module of the checkout at `root`, imported as a
    package of its own (`_other_port`), so its kernel builds from root's
    source into root's build directory."""
    pkg = Path(root).resolve() / "subgnn_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        "_other_port", pkg / "__init__.py",
        submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["_other_port"] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module("_other_port.ops.embedding")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--against", type=Path, default=None, metavar="DIR",
                    help="another checkout whose segment_matmul is timed "
                         "in turns with this one's")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    other = other_embedding(args.against) if args.against else None
    print(card(), flush=True)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    for dt in ("bfloat16", "float32"):
        _, _, params, _, batch, anchors = bench_batch(dt, dev, args.seed)
        rows = params["node_embed"].shape[0]
        tdt = torch.bfloat16 if dt == "bfloat16" else torch.float32
        for name, ids, plan in bench_plans(batch, anchors):
            g = torch.randn(ids.numel(), 128, generator=gen,
                            device=dev).to(tdt)
            flat = ids.reshape(-1)
            ref = E.segment_matmul_torch(g, plan, rows)

            def this():
                return E.segment_matmul(g, plan, rows)

            def library():
                torch.zeros(rows, g.shape[1], dtype=torch.float32,
                            device=dev).index_add_(0, flat, g.float())

            record = {"dtype": dt, "B": batch["cc_ids"].shape[0],
                      "plan": name, "tiles": plan.pos.shape[0],
                      "bound_ms": segment_bound_ms(g, plan, rows)}
            turns = [("this", this)]
            if other is not None:
                def before():
                    return other.segment_matmul(g, plan, rows)
                turns = [("other", before), ("this", this), ("this", this),
                         ("other", before)]
            for who, fn in turns[:2]:
                record[f"{who}_max_abs_err"] = float(
                    (fn().float() - ref.float()).abs().max())
            runs: dict = {}
            for who, fn in turns:
                times = device_times(fn)
                times["call_ms"] = statistics.median(
                    event_ms(fn, EAGER_CALLS) for _ in range(EAGER_LOOPS))
                runs.setdefault(who, []).append(times)
            for who, rs in runs.items():
                record[who] = {
                    "device_ms": min(r["device_ms"] for r in rs),
                    "span_ms": min(r["span_ms"] for r in rs),
                    "call_ms": min(r["call_ms"] for r in rs),
                    "runs_call_ms": [r["call_ms"] for r in rs],
                    "runs_device_ms": [r["device_ms"] for r in rs],
                    "activities": rs[0]["activities"]}
            lib = device_times(library)
            record["library"] = {"device_ms": lib["device_ms"],
                                 "call_ms": event_ms(library, 20)}
            record["plain_ms"] = event_ms(
                lambda: E.segment_matmul_torch(g, plan, rows), 3)
            print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
