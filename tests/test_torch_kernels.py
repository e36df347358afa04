"""Hand-written CUDA kernels against their plain PyTorch versions, on the
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


@pytest.mark.gpu
@pytest.mark.parametrize("Lc,La", [(15, 25), (1, 3), (32, 32), (40, 25),
                                   (100, 30), (200, 8)])
def test_dtw_kernel_matches_plain(cuda, Lc, La):
    rng = np.random.default_rng(Lc * 1000 + La)
    G, nc, na = 2, 37, 23
    cs, cl = _ragged(rng, G * nc, Lc, 0.2)
    cl[0] = Lc  # a full-length row
    as_, al = _ragged(rng, G * na, La, 0.1)
    args = [torch.as_tensor(x, device=cuda) for x in (cs, cl, as_, al)]
    before = kdtw.dtw_distance_grouped.launches
    got = kdtw.dtw_distance_grouped(*args, G, nc, na)
    assert kdtw.dtw_distance_grouped.launches == before + 1
    ref = kdtw.dtw_distance_grouped_torch(*args, G, nc, na)
    torch.cuda.synchronize()
    assert (got - ref).abs().max().item() <= 1e-5
    empty = (cl.reshape(G, nc, 1) == 0) | (al.reshape(G, 1, na) == 0)
    assert (got.cpu().numpy().reshape(G, nc, na)[empty] == 0).all()


@pytest.mark.gpu
def test_dtw_kernel_rejects_what_it_does_not_take(cuda):
    cs = torch.zeros(4, 300, device=cuda)
    cl = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        kdtw.dtw_distance_grouped(cs, cl, cs, cl, 1, 4, 4)
    with pytest.raises(ValueError):
        kdtw.dtw_distance_grouped(cs[:, :8], cl.cpu(), cs[:, :8], cl, 1, 4, 4)


# ------------------------------------------------------------ segment_matmul
#
# Tolerance, per output row: |kernel - plain| <= 1e-5 * sum of |g| over that
# row's slots (fp32 sums of the same terms in another order), plus one bf16
# ulp of the plain value where g, and so the output, is bf16 (the two sums may
# round to neighbouring bf16 values).

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
    with pytest.raises(ValueError):         # D the kernel does not take
        E.segment_matmul(torch.zeros(100, 96, device=cuda), plan)
    with pytest.raises(ValueError):         # misaligned rows
        E.segment_matmul(torch.zeros(100 * 128 + 1, device=cuda)[1:]
                         .view(100, 128), plan)
    with pytest.raises(TypeError):
        E.segment_matmul(torch.zeros(100, 128, device=cuda,
                                     dtype=torch.float16), plan)
