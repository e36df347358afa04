"""Hand-written CUDA kernels against their plain PyTorch versions, and the
fused step's device gather plans captured without a host sync, on the
card. Every test here needs a CUDA device and skips without one; the file
imports no JAX, so it runs on the GPU machine as

    python -m pytest tests/test_torch_kernels.py --noconftest -q

DTW tolerance 1e-5: the kernel repeats the plain version's fp32 operations
in the same order (IEEE division, no fast-math). segment_matmul: see its
section below.
"""
import numpy as np
import pytest
import torch

from subgnn_tpu_torch.ops import dtw as kdtw


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _ragged(rng, rows, width, empty_frac):
    lens = rng.integers(1, width + 1, rows).astype(np.int32)
    lens[rng.random(rows) < empty_frac] = 0
    seqs = np.zeros((rows, width), np.float32)
    for i in range(rows):
        seqs[i, :lens[i]] = np.sort(rng.integers(0, 40, lens[i]))
    return seqs, lens


# (Lc, La, G, nc, na): csrc/dtw.cu holds a comp of up to Lc's register
# bound (16, 32 or 64) in registers, walks a longer comp against each
# anchor that fits the bound, and gives a warp to each pair where both are
# longer (`_ragged_case` puts lengths 64 and 65 on both sides wherever the
# widths allow)
_DTW_CASES = {
    "15-25": (15, 25, 2, 37, 23), "1-3": (1, 3, 2, 37, 23),
    "32-32": (32, 32, 2, 37, 23), "40-25": (40, 25, 2, 37, 23),
    "100-30": (100, 30, 2, 37, 23), "200-8": (200, 8, 2, 37, 23),
    "empty_group": (15, 25, 3, 20, 40),      # group 1 has no comp at all
    "na1": (15, 25, 2, 37, 1),
    "na150": (15, 25, 2, 64, 150),           # the serving pool
    "na700": (40, 25, 2, 9, 700),            # more than a block's threads
    "register_bound": (64, 70, 2, 12, 40),   # la and lb at 64, none past
    "past_register_bound": (65, 70, 2, 12, 40),
    "Lc300": (300, 25, 2, 10, 30),
    "Lc1000": (1000, 80, 1, 6, 40),
    "La_gt_Lc": (70, 300, 2, 8, 35),
    "La_lt_Lc": (300, 100, 2, 8, 35),
    "G1": (15, 25, 1, 50, 23), "G3": (40, 70, 3, 25, 23),
    # 1 x 1 pairs: every distance is one quotient, (max+1)/(min+1) - 1, over
    # values from 0 to 2^62 and in (-1, 0); the kernel's own division takes
    # values in [0, 2^60 - 1], a warp with IEEE division the rest
    "division": (1, 1, 1, 1024, 2048),
    "out_of_range": (15, 25, 2, 37, 23),    # such values in longer pairs
}


def _odd_values(rng, n):
    return np.concatenate([
        rng.integers(0, 10 ** 6, n // 4),
        2.0 ** rng.uniform(-30, 62, n // 2),
        -rng.random(n - n // 4 - n // 2)]).astype(np.float32)


def _ragged_case(rng, name):
    Lc, La, G, nc, na = _DTW_CASES[name]
    cs, cl = _ragged(rng, G * nc, Lc, 0.2)
    as_, al = _ragged(rng, G * na, La, 0.1)
    for seqs, lens, width in ((cs, cl, Lc), (as_, al, La)):
        for row, n in enumerate((width, 64, 65)):  # full length, the switch
            if row < len(lens) and n <= width:
                lens[row] = n
                seqs[row, :n] = np.sort(rng.integers(0, 40, n))
    cl[-1] = al[-1] = 0                      # an empty pair on each side
    if name == "empty_group":
        cl[nc:2 * nc] = 0
    if name == "division":
        cs[:, 0] = _odd_values(rng, len(cs))
        as_[:, 0] = _odd_values(rng, len(as_))
    if name == "out_of_range":
        for seqs, lens in ((cs, cl), (as_, al)):
            for row in rng.choice(len(lens) - 1, 4, replace=False):
                seqs[row, rng.integers(0, lens[row] or 1)] = rng.choice(
                    [-0.5, 2.0 ** 61])
    return (cs, cl, as_, al), G, nc, na


@pytest.mark.gpu
@pytest.mark.parametrize("Lc,La", [
    pytest.param(*_DTW_CASES[name][:2], id=name) for name in _DTW_CASES])
def test_dtw_kernel_matches_plain(cuda, request, Lc, La):
    name = request.node.callspec.id
    rng = np.random.default_rng(sum(map(ord, name)) * 1000 + Lc)
    arrays, G, nc, na = _ragged_case(rng, name)
    cl, al = arrays[1], arrays[3]
    args = [torch.as_tensor(x, device=cuda) for x in arrays]
    before = kdtw.dtw_distance_grouped.launches
    pairs = kdtw.dtw_distance_grouped.pairs
    got = kdtw.dtw_distance_grouped(*args, G, nc, na)
    again = kdtw.dtw_distance_grouped(*args, G, nc, na)
    assert kdtw.dtw_distance_grouped.launches == before + 2
    assert kdtw.dtw_distance_grouped.pairs == pairs + 2 * G * nc * na
    ref = kdtw.dtw_distance_grouped_torch(*args, G, nc, na)
    torch.cuda.synchronize()
    assert (got - ref).abs().max().item() <= 1e-5
    assert torch.equal(got, again)          # deterministic: same bits
    empty = (cl.reshape(G, nc, 1) == 0) | (al.reshape(G, 1, na) == 0)
    assert empty.any()
    assert (got.cpu().numpy().reshape(G, nc, na)[empty] == 0).all()


@pytest.mark.gpu
def test_dtw_kernel_rejects_what_it_does_not_take(cuda):
    cs = torch.zeros(4, 300, device=cuda)  # a width the first kernel refused
    cl = torch.zeros(4, dtype=torch.int32, device=cuda)
    got = kdtw.dtw_distance_grouped(cs, cl, cs, cl, 1, 4, 4)
    assert got.shape == (16,) and (got == 0).all()
    # anchors past the shared-memory strip bound are taken, not refused
    long_anchors = torch.zeros(4, kdtw.MAX_STRIP_LA + 1, device=cuda)
    got = kdtw.dtw_distance_grouped(cs, cl, long_anchors, cl, 1, 4, 4)
    assert got.shape == (16,) and (got == 0).all()
    with pytest.raises(ValueError):
        kdtw.dtw_distance_grouped(cs[:, :8], cl.cpu(), cs[:, :8], cl, 1, 4, 4)
    with pytest.raises(TypeError):
        kdtw.dtw_distance_grouped(cs, cl.long(), cs, cl, 1, 4, 4)


def _long_anchor_case(La, anchor_lens, comp_lens, Lc=300, seed=7):
    """(comp_seqs, comp_lens, anchor_seqs, anchor_lens) numpy, one group:
    sorted degree-like values, anchors La wide."""
    rng = np.random.default_rng(seed)

    def seqs(lens, width):
        out = np.zeros((len(lens), width), np.float32)
        for i, n in enumerate(lens):
            out[i, :n] = np.sort(rng.integers(0, 40, n))
        return out, np.asarray(lens, np.int32)
    return (*seqs(comp_lens, Lc), *seqs(anchor_lens, La))


@pytest.mark.gpu
def test_dtw_kernel_long_anchors_past_the_shared_strip(cuda):
    """La = 60,000 > MAX_STRIP_LA: comps of up to 64 in registers walking
    the anchors, longer ones on the warp path with its strip boundary in
    global scratch; held against the plain version."""
    La = 60_000
    assert La > kdtw.MAX_STRIP_LA
    cs, cl, as_, al = _long_anchor_case(La, [La, 59_000, 5],
                                        [300, 40, 0, 120, 64, 65])
    args = [torch.as_tensor(x, device=cuda) for x in (cs, cl, as_, al)]
    before = kdtw.dtw_distance_grouped.launches
    got = kdtw.dtw_distance_grouped(*args, 1, 6, 3)
    assert kdtw.dtw_distance_grouped.launches == before + 1
    ref = kdtw.dtw_distance_grouped_torch(*args, 1, 6, 3)
    torch.cuda.synchronize()
    assert (got - ref).abs().max().item() <= 1e-5
    assert (got.cpu().numpy().reshape(6, 3)[2] == 0).all()   # empty comp


def test_dtw_wrapper_takes_anchors_past_the_strip_bound_on_the_cpu():
    """A CPU tensor takes the plain version at any La: 60,000-wide anchors
    give the distances of the same sequences at their own width."""
    La = 60_000
    cs, cl, as_, al = _long_anchor_case(La, [900, 31, 0, 5], [30, 0, 7],
                                        Lc=30)
    wide = kdtw.dtw_distance_grouped(*map(torch.as_tensor,
                                          (cs, cl, as_, al)), 1, 3, 4)
    narrow = kdtw.dtw_distance_grouped_torch(
        *map(torch.as_tensor, (cs, cl, np.ascontiguousarray(as_[:, :900]),
                               al)), 1, 3, 4)
    assert torch.equal(wide, narrow)
    assert (wide.reshape(3, 4)[1] == 0).all() and \
        (wide.reshape(3, 4)[:, 2] == 0).all()
    assert (wide.reshape(3, 4)[[0, 2]][:, [0, 1, 3]] > 0).all()


def test_dtw_strip_scratch_warps():
    assert kdtw.strip_scratch_warps(kdtw.MAX_STRIP_LA, 10_000) == 0
    La = kdtw.MAX_STRIP_LA + 1
    assert kdtw.strip_scratch_warps(La, 3) == 8          # at least 8
    assert kdtw.strip_scratch_warps(La, 10_000) == kdtw.STRIP_WARPS
    assert kdtw.STRIP_WARPS % 8 == 0
    for La in (60_000, 1_000_000, 10_000_000):
        warps = kdtw.strip_scratch_warps(La, 10 ** 9)
        assert warps % 8 == 0 and warps >= 8
        assert warps * La * 4 <= max(kdtw.STRIP_SCRATCH_BYTES, 8 * La * 4)


def test_dtw_kernel_block_warps_depend_on_grid_size_alone():
    # chip_smoke's serving request and kernel_times' dense set (1920 comps
    # x 150 anchors), its long set (32 comps), the pool of the configs (50)
    assert kdtw.kernel_block_warps(1920, 150) == 8
    assert kdtw.kernel_block_warps(32, 150) == 1
    assert kdtw.kernel_block_warps(66, 256) == 2
    for n_comps in (1, 7, 33, 132, 264, 1000):
        for na in (1, 31, 32, 150, 700):
            w = kdtw.kernel_block_warps(n_comps, na)
            blocks = n_comps * -(-(-(-na // 32)) // w)
            assert w in (1, 2, 4, 8)
            assert w == 1 or blocks >= kdtw.KERNEL_MIN_BLOCKS
            assert w == 8 or n_comps * -(-(-(-na // 32)) // (2 * w)) \
                < kdtw.KERNEL_MIN_BLOCKS


# ------------------------------------------------------------ segment_matmul
#
# Tolerance, per output row: |kernel - plain| <= 1e-5 * sum of |g| over that
# row's slots (fp32 sums of the same terms in another order), plus one bf16
# ulp of the plain value where g, and so the output, is bf16 (the two sums may
# round to neighbouring bf16 values). D of 32, 64, 128 and 256 with g 16-byte
# aligned take the kernel's vector path; every other D, and a misaligned g,
# its general path (slabs of up to 256 columns, scalar loads).

def _segment_case(rng, case, D):
    """(ids, n_rows, extra padding tiles, g, tile width). The kernel cuts
    the flat slot array into blocks of 16 warps of 8, 16, 32 or 64 slots
    (128 to 1024 slots; embedding.kernel_slots_per_warp), so slot 1024 is a
    block edge at every size."""
    from subgnn_tpu_torch.ops.embedding import TABLE_BLOCK, TILE_WIDTH
    n_rows, extra, width = 1000, 0, TILE_WIDTH
    if case == "uniform":
        ids = rng.integers(0, n_rows, (64, 3, 45))
    elif case == "pad_heavy":
        ids = rng.integers(1, n_rows, (64, 3, 45))
        ids[rng.random(ids.shape) < 0.4] = 0
    elif case == "one_row":
        ids = np.full(5 * TILE_WIDTH + 7, 300)
    elif case == "only_pad":
        ids = np.zeros((40, 16), np.int64)
    elif case == "padding_tiles":
        ids = rng.integers(0, 3 * TABLE_BLOCK, 2000)
        n_rows, extra = 3 * TABLE_BLOCK, 5
    elif case == "many_blocks":             # one run over 20 kernel blocks
        ids = np.full(20 * TILE_WIDTH, 300)
    elif case == "block_edge_start":        # row 4's run starts at slot 1024
        ids = rng.permutation(np.r_[np.full(1024, 3), np.full(300, 4),
                                    rng.integers(200, n_rows, 900)])
    elif case == "pad_straddle":            # slots 1000-1151 pad, edge at 1024
        ids = np.r_[rng.integers(0, TABLE_BLOCK, 1000),
                    rng.integers(TABLE_BLOCK, 2 * TABLE_BLOCK, 700)]
        width = 384
    elif case == "small_plan":              # 64 slots, under one block
        ids = np.array([5, 5, 3, 90, 90, 90, 17])
        n_rows, width = 100, 64
    g = rng.normal(size=(ids.size, D)).astype(np.float32)
    return ids, n_rows, extra, g, width


def _row_tol(g, ids, out_rows, plain):
    absum = torch.zeros(out_rows, g.shape[1], dtype=torch.float32,
                        device=g.device).index_add_(
        0, torch.as_tensor(ids.reshape(-1), device=g.device),
        g.float().abs())
    tol = 1e-5 * absum
    if g.dtype == torch.bfloat16:
        tol = tol + plain.float().abs() * 2.0 ** -7
    return tol


def _check_segment_case(cuda, monkeypatch, case, D, dtype, sw):
    from subgnn_tpu_torch.ops import embedding as E
    rng = np.random.default_rng(sum(map(ord, case)) * 1000 + D)
    ids, n_rows, extra, g_np, width = _segment_case(rng, case, D)
    monkeypatch.setattr(E, "TILE_WIDTH", width)
    monkeypatch.setattr(E, "kernel_slots_per_warp", lambda n_slots: sw)
    plan = E.make_gather_plan(ids, n_rows,
                              E.tiles_needed(ids, n_rows) + extra).to(cuda)
    g = torch.as_tensor(g_np, device=cuda).to(dtype)
    out_rows = n_rows + 24                  # table rows past the plan
    before = E.segment_matmul.launches
    got = E.segment_matmul(g, plan, out_rows)
    again = E.segment_matmul(g, plan, out_rows)
    assert E.segment_matmul.launches == before + 2
    ref = E.segment_matmul_torch(g, plan, out_rows)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (out_rows, D)
    assert torch.equal(got, again)          # deterministic: same bits
    err = (got.float() - ref.float()).abs()
    assert (err <= _row_tol(g, ids, out_rows, ref)).all()
    assert (got[n_rows:] == 0).all()
    assert not any(t.any() for t in E._tickets.values())  # left 0


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["uniform", "pad_heavy", "one_row",
                                  "only_pad", "padding_tiles", "many_blocks",
                                  "block_edge_start", "pad_straddle",
                                  "small_plan"])
@pytest.mark.parametrize("D,dtype", [
    (128, torch.float32), (128, torch.bfloat16), (32, torch.bfloat16),
    (256, torch.float32), (32, torch.float32), (64, torch.float32),
    (64, torch.bfloat16), (256, torch.bfloat16)])
@pytest.mark.parametrize("sw", [8, 16, 32, 64])
def test_segment_matmul_kernel_matches_plain(cuda, monkeypatch, case, D,
                                             dtype, sw):
    _check_segment_case(cuda, monkeypatch, case, D, dtype, sw)


# widths outside the vector set: a slab narrower than a lane's first column
# (1, 8), part-filled slabs (48, 96, 100: 100 bf16 columns are 200-byte,
# unaligned rows) and two slabs (384 = 256 + 128)
@pytest.mark.gpu
@pytest.mark.parametrize("case", ["uniform", "pad_heavy", "one_row",
                                  "only_pad", "padding_tiles", "many_blocks",
                                  "pad_straddle"])
@pytest.mark.parametrize("D", [1, 8, 48, 96, 100, 384])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sw", [8, 64])
def test_segment_matmul_kernel_takes_any_width(cuda, monkeypatch, case, D,
                                               dtype, sw):
    _check_segment_case(cuda, monkeypatch, case, D, dtype, sw)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_segment_matmul_kernel_takes_misaligned_rows(cuda, dtype):
    # a fast-set D whose g does not start on 16 bytes takes the general
    # path, as the JAX package takes any layout
    from subgnn_tpu_torch.ops import embedding as E
    rng = np.random.default_rng(7)
    ids = rng.integers(0, 300, 2500)
    plan = E.make_gather_plan(ids, 300).to(cuda)
    g = torch.as_tensor(rng.normal(size=(ids.size * 128 + 1)), device=cuda,
                        dtype=dtype)[1:].view(ids.size, 128)
    assert g.data_ptr() % 16
    got = E.segment_matmul(g, plan)
    again = E.segment_matmul(g, plan)
    ref = E.segment_matmul_torch(g, plan)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    err = (got.float() - ref.float()).abs()
    assert (err <= _row_tol(g, ids, 300, ref)).all()


def test_segment_matmul_kernel_partition_depends_on_plan_size_alone():
    from subgnn_tpu_torch.ops import embedding as E
    # the bench's four plans (tiles of 512 slots): bf16 B=1280 neigh and cc,
    # fp32 B=512 neigh and cc
    sizes = {767: 64, 150: 16, 301: 32, 100: 8, 1: 8}
    for tiles, sw in sizes.items():
        assert E.kernel_slots_per_warp(tiles * 512) == sw
    for n_slots in range(1, 600_000, 997):
        sw = E.kernel_slots_per_warp(n_slots)
        blocks = -(-n_slots // (E.KERNEL_WARPS * sw))
        assert sw == 8 or blocks >= E.KERNEL_MIN_BLOCKS
        assert sw == 64 or -(-n_slots // (E.KERNEL_WARPS * 2 * sw)) \
            < E.KERNEL_MIN_BLOCKS


@pytest.mark.gpu
def test_segment_matmul_kernel_rejects_what_it_does_not_take(cuda):
    from subgnn_tpu_torch.ops import embedding as E
    ids = np.arange(100)
    plan = E.make_gather_plan(ids, 128)
    with pytest.raises(ValueError):         # plan left on the CPU
        E.segment_matmul(torch.zeros(100, 128, device=cuda), plan)
    plan = plan.to(cuda)
    with pytest.raises(ValueError):         # not contiguous
        E.segment_matmul(torch.zeros(128, 100, device=cuda).t(), plan)
    with pytest.raises(ValueError):         # no columns
        E.segment_matmul(torch.zeros(100, 0, device=cuda), plan)
    with pytest.raises(TypeError):
        E.segment_matmul(torch.zeros(100, 128, device=cuda,
                                     dtype=torch.float16), plan)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_segment_matmul_kernel_captured_and_replayed(cuda, dtype):
    """The table-gradient kernel inside a CUDA graph (train/graphs.py, as
    the fused trainer runs it): call 1 eager, call 2 captured and
    replayed, calls 3-4 replays, each with a new g and a new plan copied
    into the step's static buffers; every call equals the plain version and
    adds one to `launches`."""
    from subgnn_tpu_torch.ops import embedding as E
    from subgnn_tpu_torch.train.graphs import StepGraph
    rng = np.random.default_rng(11)
    n_rows, D, shape = 1000, 128, (64, 3, 45)
    draws = [rng.integers(0, n_rows, shape) for _ in range(4)]
    draws[1][rng.random(shape) < 0.4] = 0            # PAD-heavy
    tiles = max(E.tiles_needed(ids, n_rows) for ids in draws) + 2
    plans = [E.make_gather_plan(ids, n_rows, tiles).to(cuda)
             for ids in draws]
    gs = [torch.as_tensor(rng.normal(size=(ids.size, D)), device=cuda,
                          dtype=dtype) for ids in draws]
    g, plan = torch.empty_like(gs[0]), E.GatherPlan(
        *(torch.empty_like(t) for t in plans[0][:3]), n_rows)
    out = torch.empty(n_rows + 8, D, device=cuda, dtype=dtype)

    def step():
        out.copy_(E.segment_matmul(g, plan, n_rows + 8))

    graph = StepGraph(step, cuda)
    for i, (ids, p, gi) in enumerate(zip(draws, plans, gs)):
        g.copy_(gi)
        for dst, src in zip(plan[:3], p[:3]):
            dst.copy_(src)
        before = E.segment_matmul.launches
        graph()
        assert E.segment_matmul.launches == before + 1
        ref = E.segment_matmul_torch(gi, p, n_rows + 8)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs()
        assert (err <= _row_tol(gi, ids, n_rows + 8, ref)).all(), i
    assert graph.captures == 1 and graph.graph is not None
    assert not any(t.any() for t in E._tickets.values())  # left 0


@pytest.mark.gpu
def test_device_gather_plan_captured_without_a_host_sync(cuda):
    """The gather plans a fused train step builds on the card
    (train/plans.py:device_gather_plan) inside a StepGraph: call 1 eager,
    call 2 captured and replayed, calls 3-4 replays, each on new ids copied
    into the step's static buffer, under
    torch.cuda.set_sync_debug_mode("error"), which raises on any host
    sync. Each call's plan equals make_gather_plan's at plan_tiles_bound
    tiles, at ppi_bp's neighbourhood shape (PAD shares 0-95%)."""
    from subgnn_tpu_torch.ops import embedding as E
    from subgnn_tpu_torch.train.graphs import StepGraph
    from subgnn_tpu_torch.train.plans import (device_gather_plan,
                                              plan_tiles_bound)
    rng = np.random.default_rng(12)
    n_rows, shape = 17080, (2, 64, 59, 45)
    draws = []
    for pad in (0.873, 0.5, 0.95, 0.0):
        ids = rng.integers(1, n_rows, shape)
        ids[rng.random(shape) < pad] = 0
        draws.append(ids)
    ids_buf = torch.zeros(shape, dtype=torch.int64, device=cuda)
    out = {}

    def step():
        out["plan"] = device_gather_plan(ids_buf, n_rows)

    graph = StepGraph(step, cuda)
    bound = plan_tiles_bound(ids_buf.numel(), n_rows)
    for i, ids in enumerate(draws):
        ids_buf.copy_(torch.as_tensor(ids, device=cuda))
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            graph()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        want = E.make_gather_plan(ids, n_rows, n_tiles=bound)
        for name in ("pos", "local", "block"):
            assert torch.equal(getattr(out["plan"], name).cpu(),
                               getattr(want, name)), (i, name)
    assert graph.captures == 1 and graph.graph is not None


@pytest.mark.gpu
@pytest.mark.parametrize("D", [128, 64, 20, 1])
def test_spmm_through_segment_sum_matches_plain(cuda, D):
    """The node-embedding pretrainer's SpMM (prepare/node_emb.py): the
    gather x[src] (embedding_gather, backward by a src plan) and the sum by
    dst (segment_sum), forward and backward on the kernel, against the
    plain version of each sum on the same inputs, at a power-law in-degree
    with a hub row of 1,500 edges (three tiles of 512 slots). Same
    tolerance as above; two launches a direction, the same bits twice."""
    from subgnn_tpu_torch.ops import embedding as E
    rng = np.random.default_rng(D)
    n = 3000
    dst = np.concatenate([np.minimum(rng.zipf(1.8, 20000), n) - 1,
                          np.full(1500, 7)])
    src = rng.integers(0, n, dst.size)
    plan_src = E.make_gather_plan(src, n).to(cuda)
    plan_dst = E.make_gather_plan(dst, n).to(cuda)
    src_t = torch.as_tensor(src, device=cuda)
    dst_t = torch.as_tensor(dst, device=cuda)
    x = torch.as_tensor(rng.normal(size=(n, D)), dtype=torch.float32,
                        device=cuda)
    g = torch.as_tensor(rng.normal(size=(n, D)), dtype=torch.float32,
                        device=cuda)

    def run():
        xx = x.clone().requires_grad_()
        out = E.segment_sum(E.embedding_gather(xx, src_t, plan_src), dst_t,
                            plan_dst)
        dx, = torch.autograd.grad(out, xx, g)
        return out.detach(), dx

    before = E.segment_matmul.launches
    out, dx = run()
    out2, dx2 = run()
    assert E.segment_matmul.launches == before + 4
    msgs, back = x[src_t], g[dst_t]
    ref = E.segment_matmul_torch(msgs, plan_dst)
    ref_dx = E.segment_matmul_torch(back, plan_src, n)
    torch.cuda.synchronize()
    assert torch.equal(out, out2) and torch.equal(dx, dx2)
    assert ((out - ref).abs() <= _row_tol(msgs, dst, n, ref)).all()
    assert ((dx - ref_dx).abs() <= _row_tol(back, src, n, ref_dx)).all()


@pytest.mark.parametrize("lost", ["none", "first_calls", "last_calls",
                                  "one_copy", "one_activity"])
def test_device_times_keeps_only_whole_calls(lost):
    """kernel_times cuts a trace at its flush copies; calls the profiler
    cut short or ran together are left out, and the rest are taken from
    the middle of the trace."""
    from subgnn_tpu_torch.kernel_times import whole_calls
    calls = [[("memset", i), ("kernel", i)] for i in range(30)]
    if lost == "first_calls":
        calls = [[("kernel", 3)]] + calls[4:]
    elif lost == "last_calls":
        calls = calls[:25] + [[("memset", 25)]]
    elif lost == "one_copy":
        calls = calls[:10] + [calls[10] + calls[11]] + calls[12:]
    elif lost == "one_activity":
        calls[10] = calls[10][:1]
    picked = whole_calls(calls, 20)
    assert len(picked) == 20
    assert all(len(a) == 2 and a[0][1] == a[1][1] for a in picked)
    ids = [a[0][1] for a in picked]
    assert ids == sorted(set(ids))
    assert whole_calls(calls, 40) == [a for a in calls if len(a) == 2]
    assert whole_calls([[], []], 1) == []


@pytest.mark.gpu
@pytest.mark.parametrize("n_node", [2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_shard_gather_backward_on_the_kernel(cuda, n_node, dtype):
    """A node-sharded table's gather (ops/embedding.py:shard_gather, the
    node axis of parallel/mesh.py): each shard's gradient through its
    shard plan on the kernel, one launch a shard, against the plain
    version of the same plan, and the shards' forward terms summing to
    table[ids] exactly. A third of the ids on PAD row 0, rows 4,100 a shard
    at n_node 2 (not a multiple of the 128-row plan block)."""
    from subgnn_tpu_torch.ops import embedding as E
    rng = np.random.default_rng(n_node)
    rows, D = 8200, 128
    ids = rng.integers(0, rows, (64, 45))
    ids[:, :15] = 0
    table = torch.as_tensor(rng.normal(size=(rows, D)), device=cuda).to(dtype)
    ids_t = torch.as_tensor(ids, device=cuda)
    g = torch.as_tensor(rng.normal(size=ids.shape + (D,)),
                        device=cuda).to(dtype)
    n = rows // n_node
    total = torch.zeros(ids.shape + (D,), dtype=dtype, device=cuda)
    for k in range(n_node):
        lo = k * n
        plan = E.make_gather_plan(ids, rows, row_range=(lo, lo + n)).to(cuda)
        shard = table[lo:lo + n].clone().requires_grad_()
        before = E.segment_matmul.launches
        out = E.shard_gather(shard, ids_t, lo, plan)
        grad, = torch.autograd.grad(out, shard, g)
        assert E.segment_matmul.launches == before + 1
        total += out.detach()
        flat = g.reshape(-1, D)
        ref = E.segment_matmul_torch(flat, plan, n)
        local = ids.reshape(-1) - lo
        keep = (local >= 0) & (local < n)
        tol = _row_tol(flat[torch.as_tensor(keep, device=cuda)],
                       local[keep], n, ref)
        torch.cuda.synchronize()
        assert ((grad.float() - ref.float()).abs() <= tol).all(), k
    assert torch.equal(total, table[ids_t])
