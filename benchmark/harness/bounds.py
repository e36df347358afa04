"""The card's published peaks and the least time of the two kernels, counted
from the ids and lengths a call is given, never from the program's plans.

Peaks: NVIDIA H100 SXM data sheet, dense, at the 700 W limit: 67 TFLOP/s in
float32 outside the tensor cores, 3.35 TB/s of HBM3.
"""
from __future__ import annotations

import numpy as np

PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
DTW_FLOPS_PER_CELL = 8      # max, min, 2 adds, 1 div, 1 sub, 3-way min
PAD = 0


def segment_bytes(ids: np.ndarray, table_rows: int, dim: int,
                  elem: int = 4) -> int:
    """Bytes the table gradient of `table[ids]` needs: each non-pad id and
    its cotangent row read once, the (table_rows, dim) gradient written
    once."""
    n = int((np.asarray(ids) != PAD).sum())
    return n * (4 + dim * elem) + table_rows * dim * elem


def dtw_bound_s(comp_lens: np.ndarray, anchor_lens: np.ndarray,
                groups: int = 2) -> float:
    """Least seconds of one grouped DTW launch (internal and border groups
    of the same comps and anchors): the DP cells the lengths need at
    DTW_FLOPS_PER_CELL operations each, or the inputs read and the output
    written once, whichever is longer."""
    cl = np.asarray(comp_lens, np.int64)
    al = np.asarray(anchor_lens, np.int64)
    cells = groups * int(cl.sum()) * int(al.sum())
    ops_s = cells * DTW_FLOPS_PER_CELL / PEAK_FP32_FLOPS
    n_bytes = groups * (4 * (cl.sum() + len(cl) + al.sum() + len(al))
                        + 4 * len(cl) * len(al))
    return max(ops_s, n_bytes / PEAK_HBM_BYTES)
