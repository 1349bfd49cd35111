"""The model FLOPs of one decoder-with-experts pretraining step, from the
configuration's shapes and the step's batch.

A matrix product of (m, k) by (k, n) is 2 m k n FLOPs. The forward pass
counts, per token and layer: the Q, K, V and output projections, the
router, and top-k SwiGLU experts (three d x ff products each); attention's
two products over the causal half of the keys ((S + 1) / 2 on average);
per token once: the tied readout (2 d V). The backward pass counts twice
the forward; recomputation is not counted.
"""
from __future__ import annotations


def forward_flops(conf: dict, seq_len: int, rows: int) -> float:
    d, L = conf["hidden_size"], conf["num_hidden_layers"]
    h, kv = conf["num_attention_heads"], conf["num_key_value_heads"]
    hd = d // h
    E, K, f = (conf["num_local_experts"], conf["num_experts_per_tok"],
               conf["intermediate_size"])
    V = conf["vocab_size"]
    tokens = rows * seq_len
    proj = 2 * d * (2 * h * hd + 2 * kv * hd)
    attn = 4 * h * hd * (seq_len + 1) / 2
    router = 2 * d * E
    experts = K * 3 * 2 * d * f
    return float(tokens * (L * (proj + attn + router + experts) + 2 * d * V))


def step_flops(conf: dict, batch) -> float:
    rows, seq_len = batch["tokens"].shape
    return 3.0 * forward_flops(conf, seq_len, rows)
