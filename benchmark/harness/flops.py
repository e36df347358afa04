"""Model FLOPs of SubGNN from shapes: the matrix products of the forward
pass and, for a training step, of its backward pass (no recomputation).

Each product of an (m, k) and a (k, n) operand counts 2 m k n, once in the
forward and once more in the backward for each operand that needs a
gradient there: the similarities and the LSTM's zero initial state need
none. Two kinds of product are computed and never reach the logits, so
they get no backward: the neighborhood channel's property scores, and the
position and structure channels' component states (their messages'
aggregate and their update: those channels pass on only their property
scores). Element-wise work is not counted. The test holds
this against torch.utils.flop_counter.FlopCounterMode on the reference's
forward and backward.
"""
from __future__ import annotations

from typing import Dict


def hid_dim(hp: Dict) -> int:
    D, nl = hp["node_embed_size"], hp["n_layers"]
    d = D
    if hp["use_neighborhood"]:
        d += nl * 2 * D
    if hp["use_position"]:
        d += (hp["n_anchor_patches_pos_in"] + hp["n_anchor_patches_pos_out"]) \
            * nl
    if hp["use_structure"]:
        d += 2 * hp["n_anchor_patches_structure"] * nl
    return d


def model_flops(hp: Dict, rows: int, max_cc: int, n_classes: int,
                backward: bool) -> int:
    """FLOPs of one forward (and backward) over `rows` subgraphs of
    `max_cc` components."""
    B, C, D, nl = rows, max_cc, hp["node_embed_size"], hp["n_layers"]
    fwd = bwd = 0

    def mm(m, k, n, grads):
        nonlocal fwd, bwd
        fwd += 2 * m * k * n
        bwd += 2 * m * k * n * grads

    if hp["use_structure"]:
        R = 2 * nl * hp["n_anchor_patches_structure"] * hp["n_triangular_walks"]
        T = hp["random_walk_len"]
        mm(R * T, D, 4 * D, 2)              # input projection, all steps
        mm(R, D, 4 * D, 1)                  # step 0: h is the zero state
        for _ in range(T - 1):
            mm(R, D, 4 * D, 2)
        mm(R, D, 4 * D, 2)                  # backward direction, one step
        mm(R, 2 * D, D, 2)                  # the LSTM's head
    for _ in range(nl):
        if hp["use_neighborhood"]:
            for A in (hp["n_anchor_patches_N_in"],
                      hp["n_anchor_patches_N_out"]):
                mm(B * C, A, D, 1)          # messages: sims need no grad
                mm(B * C * A, D, 1, 0)      # property scores, never read
                mm(B * C, 2 * D, D, 2)      # channel update
        if hp["use_position"]:
            A = hp["n_anchor_patches_pos_in"]
            mm(B * C, A, D, 0)              # messages to a dead state
            mm(B * A, D, 1, 2)              # property scores, read
            mm(B * C, 2 * D, D, 0)          # the dead state's update
            A = hp["n_anchor_patches_pos_out"]
            mm(B * C, A, D, 0)
            mm(A, D, 1, 2)
            mm(B * C, 2 * D, D, 0)
        if hp["use_structure"]:
            A = hp["n_anchor_patches_structure"]
            for _ in range(2):
                mm(B * C, A, D, 0)
                mm(A, D, 1, 2)
                mm(B * C, 2 * D, D, 0)
    h1, h2 = hp["linear_hidden_dim_1"], hp["linear_hidden_dim_2"]
    mm(B, hid_dim(hp), h1, 2)
    mm(B, h1, h2, 2)
    mm(B, h2, n_classes, 2)
    return fwd + (bwd if backward else 0)
