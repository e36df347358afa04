"""Device time of the port's two kernels on the card.

    python -m subgnn_tpu_torch.kernel_times [--seed 0] [--against DIR]

On one CUDA device it prints the card's name and power limit, then one JSON
line per input set:

- `segment_matmul` (the table gradient) at each of the bench's four plans
  (bf16 B=1280 and fp32 B=512, neigh and cc;
  subgnn_tpu_torch/bench.py:bench_batch): its device_ms, span_ms and
  call_ms, the device time of each of its device activities,
  `index_add_`'s device_ms and call_ms, the plain version's time
  (`plain_ms`, CUDA events around 3 calls) and the byte bound;
- `dtw_grouped` (the DTW kernel) at three seeded input sets (`dtw_set`):
  `serving`, the shape of chip_smoke.py's last serving request (2 groups x
  960 comps x 150 anchors, 121 non-empty comps a group, 5-15 long, every
  anchor 25 long); `dense`, the same widths with every comp 1-15 long;
  `long`, 32 comps 200-300 long against 150 anchors. Its device_ms,
  span_ms, call_ms, plain_ms, whether its bits equal the plain version's,
  the pairs, the non-empty pairs, the DP cells and the bound (operations or
  bytes, `dtw_bound_ms`).

  device_ms  sum of the call's own device activities (kernels, memsets),
             the L2 flushed before the call; median over 20 traced calls
  span_ms    first start to last end of those activities, so the gaps
             between one call's launches count
  call_ms    CUDA events around 50 back-to-back eager calls, per call: the
             larger of the host's enqueue time and the device time, which
             is what a host-bound training step pays; the median of 5 such
             loops in each turn, since the host's share swings between loops

`--against DIR` also times both kernels of another checkout in DIR (for
example the parent commit unpacked with `git archive`), built from DIR's
own sources into DIR's own build directory, on the same inputs and in
turns: DIR, this, this, DIR. Where DIR's kernel refuses an input set (it
raises ValueError), the refusal is recorded and only this checkout's kernel
is timed there.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import statistics
import sys
from pathlib import Path

import numpy as np
import torch

from .bench import bench_batch, card
from .device import resolve_device
from .ops import dtw as D
from .ops import embedding as E
from .train.plans import neigh_ids_for_batch

FLUSH_BYTES = 256 << 20     # copied before each traced call: > 5x the L2
TRACED_CALLS = 20
TRACE_TRIES = 3
TRACE_SPARE = 3             # untimed calls traced first (see _traced_calls)
EAGER_CALLS = 50
EAGER_LOOPS = 5
PEAK_HBM_BYTES = 3.35e12    # H100 SXM HBM3 (NVIDIA data sheet)
# H100 SXM fp32 outside the tensor cores (NVIDIA data sheet)
PEAK_FP32_FLOPS = 67e12
DTW_FLOPS_PER_CELL = 8      # max, min, 2 adds, 1 div, 1 sub, 3-way min
DTW_SETS = ("serving", "dense", "long")


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
    call's device activities, cut at the flush copies. TRACE_SPARE more
    calls run first, so a trace that misses its first copies (late in a
    long process the profiler has dropped two) still holds them all."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls + TRACE_SPARE):
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
    now and then, the first copies most often) is taken again, up to
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


def dtw_bound_ms(comp_lens, anchor_lens, G: int, nc: int, na: int,
                 n_bytes: int) -> tuple:
    """(bound ms, "operations" or "bytes", DP cells) of one grouped DTW
    call: the cells these lengths need (la x lb per pair) at
    DTW_FLOPS_PER_CELL fp32 operations each over PEAK_FP32_FLOPS, against
    `n_bytes` (inputs read once, output written once) over PEAK_HBM_BYTES."""
    cl = np.asarray(comp_lens, np.int64).reshape(G, nc)
    al = np.asarray(anchor_lens, np.int64).reshape(G, na)
    cells = int(sum((cl[g][:, None] * al[g][None, :]).sum()
                    for g in range(G)))
    ops_ms = cells * DTW_FLOPS_PER_CELL / PEAK_FP32_FLOPS * 1e3
    bytes_ms = n_bytes / PEAK_HBM_BYTES * 1e3
    return (max(ops_ms, bytes_ms),
            "operations" if ops_ms >= bytes_ms else "bytes", cells)


def _sorted_degrees(rng, lens, width: int) -> np.ndarray:
    seqs = np.zeros((len(lens), width), np.float32)
    for i, n in enumerate(lens):
        seqs[i, :n] = np.sort(rng.integers(0, 41, n))
    return seqs


def dtw_set(name: str, seed: int = 0) -> tuple:
    """(comp_seqs, comp_lens, anchor_seqs, anchor_lens, G, nc, na) numpy
    inputs of one DTW input set, sorted integer degrees 0-40:

    serving  chip_smoke.py's last request as a shape: G=2 groups (internal,
             border) of 64 subgraphs x 15 comps against 150 anchors 25
             long; subgraph s has its first 1-3 comps non-empty, 121 in a
             group, 5-15 long, the same lengths in both groups
    dense    the same widths with every comp non-empty, 1-15 long
    long     G=1, 32 comps 200-300 long (Lc=300) against 150 anchors 25
             long"""
    rng = np.random.default_rng(seed)
    if name in ("serving", "dense"):
        G, n_sub, C, na, Lc, La = 2, 64, 15, 150, 15, 25
        nc = n_sub * C
        if name == "serving":
            extra = np.zeros(2 * n_sub, np.int64)
            extra[rng.choice(2 * n_sub, 121 - n_sub, replace=False)] = 1
            n_cc = 1 + extra.reshape(n_sub, 2).sum(1)
            lens = np.zeros((n_sub, C), np.int32)
            for s, k in enumerate(n_cc):
                lens[s, :k] = rng.integers(5, Lc + 1, k)
            lens = lens.reshape(nc)
        else:
            lens = rng.integers(1, Lc + 1, nc).astype(np.int32)
    elif name == "long":
        G, nc, na, Lc, La = 1, 32, 150, 300, 25
        lens = rng.integers(200, Lc + 1, nc).astype(np.int32)
    else:
        raise ValueError(f"unknown DTW input set {name!r}; one of {DTW_SETS}")
    cl = np.tile(lens, G)
    al = np.full(G * na, La, np.int32)
    return (_sorted_degrees(rng, cl, Lc), cl, _sorted_degrees(rng, al, La),
            al, G, nc, na)


def other_ops(root: Path):
    """(ops.embedding, ops.dtw) of the checkout at `root`, imported as a
    package of its own (`_other_port`), so its kernels build from root's
    sources into root's build directory."""
    pkg = Path(root).resolve() / "subgnn_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        "_other_port", pkg / "__init__.py",
        submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["_other_port"] = mod
    spec.loader.exec_module(mod)
    return (importlib.import_module("_other_port.ops.embedding"),
            importlib.import_module("_other_port.ops.dtw"))


def timed_turns(record: dict, turns: list) -> None:
    """Time each (who, fn) of `turns` in order and put into `record`, per
    who, the least device_ms, span_ms and call_ms over its turns, each
    turn's call_ms and device_ms, and its first turn's device activities."""
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


def in_turns(this, before) -> list:
    """[(who, fn)]: this alone, or DIR, this, this, DIR."""
    if before is None:
        return [("this", this)]
    return [("other", before), ("this", this), ("this", this),
            ("other", before)]


def segment_records(dev, seed: int, other):
    """One record per bench plan for segment_matmul (`other`: DIR's
    ops.embedding or None)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    for dt in ("bfloat16", "float32"):
        _, _, params, _, batch, anchors = bench_batch(dt, dev, seed)
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

            before = None
            if other is not None:
                def before():
                    return other.segment_matmul(g, plan, rows)
            record = {"kernel": "segment_matmul", "dtype": dt,
                      "B": batch["cc_ids"].shape[0], "plan": name,
                      "tiles": plan.pos.shape[0],
                      "bound_ms": segment_bound_ms(g, plan, rows)}
            turns = in_turns(this, before)
            for who, fn in turns[:2]:
                record[f"{who}_max_abs_err"] = float(
                    (fn().float() - ref.float()).abs().max())
            timed_turns(record, turns)
            lib = device_times(library)
            record["library"] = {"device_ms": lib["device_ms"],
                                 "call_ms": event_ms(library, 20)}
            record["plain_ms"] = event_ms(
                lambda: E.segment_matmul_torch(g, plan, rows), 3)
            yield record


def dtw_records(dev, seed: int, other):
    """One record per DTW input set (`other`: DIR's ops.dtw or None)."""
    for name in DTW_SETS:
        *arrays, G, nc, na = dtw_set(name, seed)
        args = [torch.as_tensor(x, device=dev) for x in arrays]
        n_bytes = sum(x.nbytes for x in arrays) + G * nc * na * 4
        bound_ms, bound_by, cells = dtw_bound_ms(arrays[1], arrays[3], G,
                                                 nc, na, n_bytes)
        pairs = np.asarray(arrays[1]).reshape(G, nc, 1) * np.asarray(
            arrays[3]).reshape(G, 1, na)
        record = {"kernel": "dtw_grouped", "set": name, "G": G, "nc": nc,
                  "na": na, "Lc": arrays[0].shape[1],
                  "La": arrays[2].shape[1], "pairs": G * nc * na,
                  "nonempty_pairs": int((pairs > 0).sum()), "cells": cells,
                  "bound_ms": bound_ms, "bound_by": bound_by}
        ref = D.dtw_distance_grouped_torch(*args, G, nc, na)

        def this():
            return D.dtw_distance_grouped(*args, G, nc, na)

        before = None
        if other is not None:
            def before():
                return other.dtw_distance_grouped(*args, G, nc, na)
            try:
                before()
            except ValueError as e:     # DIR's kernel refuses this set
                record["other"] = {"refused": str(e)}
                before = None
        turns = in_turns(this, before)
        for who, fn in turns[:2]:
            got = fn()
            record[f"{who}_max_abs_err"] = float((got - ref).abs().max())
            record[f"{who}_bits_equal"] = torch.equal(got, ref)
        timed_turns(record, turns)
        record["plain_ms"] = event_ms(
            lambda: D.dtw_distance_grouped_torch(*args, G, nc, na), 3)
        yield record


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--against", type=Path, default=None, metavar="DIR",
                    help="another checkout whose kernels are timed in turns "
                         "with this one's")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    other_e, other_d = other_ops(args.against) if args.against else (None,
                                                                     None)
    print(card(), flush=True)
    for record in dtw_records(dev, args.seed, other_d):
        print(json.dumps(record), flush=True)
    for record in segment_records(dev, args.seed, other_e):
        print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
