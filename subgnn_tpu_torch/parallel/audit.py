"""Count the collectives a function issues, by kind, with their bytes.

The counterpart of subgnn_tpu/parallel/hlo_audit.py. The JAX package
counts the collectives GSPMD inserted into a compiled program's HLO text:
each op once, with its output bytes. The port has no HLO: its collectives
are explicit calls of the helpers of parallel/mesh.py and
parallel/collectives.py, each counting its calls and bytes as it runs. So
the counts here are of one run of `fn` (a helper called in a loop counts
once a call), and the bytes are the helpers' own: the tensor each reduces,
gathers, scatters or sends.

Kinds use JAX's names. Each helper is the kind its wire operation is:

  * all-reduce: `all_reduce_sum_`, `all_reduce_bn_stats`, `node_sum`,
    `all_reduce_node_`, `all_reduce_world_`, `sum_over_world`,
    `copy_to_world`, and the gathers `all_gather_rows`, `all_gather_node`
    (counted under `all_reduce_node_`) and `all_gather_world`, which are
    all-reduces of a zero buffer holding each rank's block in its place
    (parallel/mesh.py:_gather_by_sum);
  * collective-permute: each rotation of the ring collectives
    (`ring_all_reduce`, `ring_all_gather`, `ring_all_reduce_fused`);
  * scatter: `scatter_world_cols`, rank 0's path matrix sent a column block
    a rank. JAX's kinds have no rooted collective (every JAX device reads
    the matrix itself), so this one kind is the port's own.

The port issues no all-gather, reduce-scatter or all-to-all. Objects moved
by pickling (`broadcast_object`, `all_gather_objects`: a cache decision,
the devices' names) are not counted.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

from . import collectives as RC
from . import mesh as MX

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "collective-permute",
         "all-to-all", "scatter")

HELPER_KINDS = {
    **{h: "all-reduce" for h in MX.COLLECTIVES
       if h is not MX.scatter_world_cols},
    MX.scatter_world_cols: "scatter",
    **{h: "collective-permute" for h in RC.RING_COLLECTIVES},
}


def reset_counts() -> None:
    """Zero every counted helper of parallel/mesh.py and collectives.py."""
    MX.reset_counts()
    RC.reset_counts()


def count_collectives(fn: Callable, *args, **kwargs) -> Dict[str, Any]:
    """Reset the counters, run fn(*args, **kwargs), and return
    {"counts": {kind: calls}, "bytes": {kind: bytes}, "by_helper": {name:
    (calls, bytes)}} of what it issued on this rank (only the kinds and
    helpers it used)."""
    reset_counts()
    fn(*args, **kwargs)
    counts: Dict[str, int] = {}
    nbytes: Dict[str, int] = {}
    by_helper = {}
    for helper, kind in HELPER_KINDS.items():
        if not helper.calls:
            continue
        counts[kind] = counts.get(kind, 0) + helper.calls
        nbytes[kind] = nbytes.get(kind, 0) + helper.bytes
        by_helper[helper.__name__] = (helper.calls, helper.bytes)
    return {"counts": counts, "bytes": nbytes, "by_helper": by_helper}
