"""The model FLOPs of one BERT pretraining step, from the configuration's
shapes and the step's batch.

A matrix product of (m, k) by (k, n) is 2 m k n FLOPs. The forward pass
counts, per token: Q, K, V and the output projection (8 d^2), the MLP
(4 d ff), attention's two products over all S keys (4 S d); per masked
token: the MLM transform (2 d^2) and decoder (2 d V), as the published
BERT gathers the masked positions; per row: pooler and NSP head. The
backward pass counts twice the forward; recomputation is not counted.
"""
from __future__ import annotations


def forward_flops(conf: dict, seq_len: int, rows: int, masked: int) -> float:
    d, L = conf["hidden_size"], conf["num_hidden_layers"]
    ff, V = conf["intermediate_size"], conf["vocab_size"]
    tokens = rows * seq_len
    per_layer = tokens * (8 * d * d + 4 * d * ff + 4 * seq_len * d)
    mlm = masked * (2 * d * d + 2 * d * V)
    nsp = rows * (2 * d * d + 2 * d * 2)
    return float(L * per_layer + mlm + nsp)


def step_flops(conf: dict, batch) -> float:
    """Forward + backward FLOPs of one step on `batch` (numpy arrays of
    the whole global batch)."""
    rows, seq_len = batch["tokens"].shape
    masked = int((batch["mlm_labels"] != -100).sum())
    return 3.0 * forward_flops(conf, seq_len, rows, masked)
