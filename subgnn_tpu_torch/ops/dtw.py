"""Batched exact DTW between degree sequences: the Hopper kernel and its
plain PyTorch version.

`dtw_distance_grouped` replaces the Pallas TPU kernel
subgnn_tpu/ops/dtw_pallas.py:_dtw_kernel together with the chunked pair
gather around it (subgnn_tpu/precompute/dtw.py:_all_chunks_grouped): one
launch of csrc/dtw.cu covers every (comp, anchor) pair of G same-shaped
products. A block takes one comp and up to 8 warps of its anchors
(`kernel_block_warps`), and writes zeros and exits if the comp is empty;
each thread runs one pair with the DP column of a side no longer than the
register bound (16 to 64) in registers; a pair whose sequences are both
longer, or hold a value outside [0, 2^60 - 1], takes a whole warp. On the
H100 the kernel is bound by fp32 operations (about 8 flops with one IEEE
division per DP cell); see the source for the design.

A CPU tensor takes the plain version (`dtw_distance_grouped_torch`); a CUDA
tensor launches the kernel or raises. The plain version is also what the
kernel is held against on the card.
"""
from __future__ import annotations

import ctypes

import torch

_PLAIN_CHUNK = 1 << 16  # pairs per plain-version chunk (bounds memory)
KERNEL_MIN_BLOCKS = 264  # two kernel blocks for each of an H100's 132 SMs
# csrc/dtw.cu's warp path keeps La floats a warp of the 227 KB a block may
# share; above MAX_STRIP_LA it keeps them in global scratch instead: La
# floats for each of at most STRIP_WARPS warps, STRIP_SCRATCH_BYTES at most
# in all (but at least 8 warps)
MAX_STRIP_LA = 232448 // 4
STRIP_WARPS = 264
STRIP_SCRATCH_BYTES = 256 << 20


def dtw_distance_torch(a: torch.Tensor, la: torch.Tensor,
                       b: torch.Tensor, lb: torch.Tensor) -> torch.Tensor:
    """Exact DTW distance for N independent sequence pairs.

    a: (N, La) float32 zero-padded, la: (N,) true lengths; b: (N, Lb),
    lb: (N,). Returns (N,) float32; a pair with an empty sequence gets 0.
    Anti-diagonal wavefront, a transcription of
    subgnn_tpu/precompute/dtw.py:dtw_distance_batch: a Python loop over the
    diagonals up to the last one a pair's answer lies on (at most La+Lb-1),
    vector work over (pairs, rows).
    """
    N, La = a.shape
    Lb = b.shape[1]
    dev = a.device
    rows = torch.arange(La, device=dev)
    la = la.to(torch.int64)
    lb = lb.to(torch.int64)
    target_k = la + lb - 2          # the answer lives on this anti-diagonal
    target_i = (la - 1).clamp(0, La - 1)[:, None]
    inf = float("inf")
    prev = torch.full((N, La), inf, device=dev)
    prev2 = torch.full((N, La), inf, device=dev)
    ans = torch.zeros(N, device=dev)
    pad = torch.full((N, 1), inf, device=dev)
    last = int(target_k.max()) if N else -1
    for k in range(min(La + Lb - 1, last + 1)):
        j = k - rows                # column index per row on diagonal k
        valid = (j >= 0) & (j < Lb)
        bv = b[:, j.clamp(0, Lb - 1)]
        mx = torch.maximum(a, bv)
        mn = torch.minimum(a, bv)
        c = torch.where(valid[None, :], (mx + 1.0) / (mn + 1.0) - 1.0, inf)
        left = torch.cat([pad, prev[:, :-1]], dim=1)    # (i-1, j)
        diag = torch.cat([pad, prev2[:, :-1]], dim=1)   # (i-1, j-1)
        best = torch.minimum(torch.minimum(prev, left), diag)
        if k == 0:
            best[:, 0] = 0.0
        cur = c + best
        ans = torch.where(target_k == k, cur.gather(1, target_i)[:, 0], ans)
        prev2, prev = prev, cur
    return torch.where((la == 0) | (lb == 0), 0.0, ans)


def _pair_index(start: int, end: int, nc: int, na: int,
                device) -> tuple[torch.Tensor, torch.Tensor]:
    """Block-diagonal pair -> (comp row, anchor row), as
    subgnn_tpu/precompute/dtw.py:_all_chunks_grouped maps them."""
    p = torch.arange(start, end, device=device)
    g, r = p // (nc * na), p % (nc * na)
    return g * nc + r // na, g * na + r % na


def dtw_distance_grouped_torch(comp_seqs, comp_lens, anchor_seqs,
                               anchor_lens, G: int, nc: int,
                               na: int) -> torch.Tensor:
    """Plain version of `dtw_distance_grouped`: gathers each chunk's pairs
    and runs `dtw_distance_torch` on them."""
    n_pairs = G * nc * na
    out = torch.empty(n_pairs, dtype=torch.float32, device=comp_seqs.device)
    for s in range(0, n_pairs, _PLAIN_CHUNK):
        e = min(s + _PLAIN_CHUNK, n_pairs)
        ic, ia = _pair_index(s, e, nc, na, comp_seqs.device)
        out[s:e] = dtw_distance_torch(comp_seqs[ic], comp_lens[ic],
                                      anchor_seqs[ia], anchor_lens[ia])
    return out


_lib = None


def _kernel():
    global _lib
    if _lib is None:
        from .build import load
        lib = load("dtw")
        fn = lib.subgnn_dtw_grouped
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 3 + [
            ctypes.c_int] * 3 + [ctypes.c_void_p, ctypes.c_longlong,
                                 ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = fn
    return _lib


def kernel_block_warps(n_comps: int, na: int) -> int:
    """Warps of anchors a kernel block may take (csrc/dtw.cu splits a
    comp's anchors evenly over the fewest blocks of at most this many):
    the most of 8, 4, 2 that still gives KERNEL_MIN_BLOCKS blocks for
    `n_comps` (G*nc) comps, else 1. A grid of few comps (long ones, say)
    so spreads its pairs over more SMs; it depends on the shapes alone."""
    need = -(-na // 32)
    for warps in (8, 4, 2):
        if n_comps * -(-need // warps) >= KERNEL_MIN_BLOCKS:
            return warps
    return 1


def strip_scratch_warps(La: int, n_pairs: int) -> int:
    """Warps of csrc/dtw.cu's global strip kernel for anchors longer than
    MAX_STRIP_LA (0 at or below it): STRIP_WARPS, or fewer where the pairs
    or STRIP_SCRATCH_BYTES of La-float boundaries call for fewer, in
    multiples of 8."""
    if La <= MAX_STRIP_LA:
        return 0
    warps = min(STRIP_WARPS, n_pairs, STRIP_SCRATCH_BYTES // (4 * La))
    return max(8, warps // 8 * 8)


def _check(comp_seqs, comp_lens, anchor_seqs, anchor_lens, G, nc, na):
    dev = comp_seqs.device
    for name, t, dt, shape in (
            ("comp_seqs", comp_seqs, torch.float32, (G * nc, None)),
            ("comp_lens", comp_lens, torch.int32, (G * nc,)),
            ("anchor_seqs", anchor_seqs, torch.float32, (G * na, None)),
            ("anchor_lens", anchor_lens, torch.int32, (G * na,))):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, comp_seqs on {dev}")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if t.dim() != len(shape) or any(
                want is not None and got != want
                for got, want in zip(t.shape, shape)):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape} (None = any)")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def dtw_distance_grouped(comp_seqs: torch.Tensor, comp_lens: torch.Tensor,
                         anchor_seqs: torch.Tensor, anchor_lens: torch.Tensor,
                         G: int, nc: int, na: int) -> torch.Tensor:
    """(G*nc*na,) float32 exact DTW distances of G independent
    (comp x anchor) products in one launch.

    comp_seqs (G*nc, Lc) float32 zero-padded degree sequences, comp_lens
    (G*nc,) int32; anchor_seqs (G*na, La), anchor_lens (G*na,). Pair p maps
    to group g = p // (nc*na), comp g*nc + r//na, anchor g*na + r%na with
    r = p % (nc*na). Lengths must not exceed the padded widths. CUDA tensors
    launch csrc/dtw.cu (any Lc and La; above MAX_STRIP_LA with a global
    scratch of `strip_scratch_warps` x La floats), add one to
    `dtw_distance_grouped.launches` and G*nc*na to its `pairs`; CPU
    tensors run the plain version.
    """
    _check(comp_seqs, comp_lens, anchor_seqs, anchor_lens, G, nc, na)
    dev = comp_seqs.device
    if dev.type == "cpu":
        return dtw_distance_grouped_torch(comp_seqs, comp_lens, anchor_seqs,
                                          anchor_lens, G, nc, na)
    if dev.type != "cuda":
        raise ValueError(f"dtw_distance_grouped: unsupported device {dev}")
    Lc, La = comp_seqs.shape[1], anchor_seqs.shape[1]
    out = torch.empty(G * nc * na, dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    warps = strip_scratch_warps(La, out.numel())
    scratch = (torch.empty(warps * La, dtype=torch.float32, device=dev)
               if warps else None)
    fn = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(comp_seqs.data_ptr(), comp_lens.data_ptr(),
                 anchor_seqs.data_ptr(), anchor_lens.data_ptr(),
                 out.data_ptr(), G, nc, na, Lc, La,
                 kernel_block_warps(G * nc, na),
                 None if scratch is None else scratch.data_ptr(), warps,
                 stream)
    if err != 0:
        raise RuntimeError(f"dtw kernel launch failed: cudaError_t {err}")
    dtw_distance_grouped.launches += 1
    dtw_distance_grouped.pairs += out.numel()
    return out


dtw_distance_grouped.launches = 0
dtw_distance_grouped.pairs = 0
