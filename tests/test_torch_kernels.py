"""Hand-written CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA device and skips without one; the file
imports no JAX, so it runs on the GPU machine as

    python -m pytest tests/test_torch_kernels.py --noconftest -q

DTW tolerance 1e-5: the kernel repeats the plain version's fp32 operations
in the same order (IEEE division, no fast-math).
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
