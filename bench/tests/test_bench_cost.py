"""The benchmark's own counts (bench/cost/) against hand counts at the
full widths, and its parameter layouts against the port's own init."""
import math

import numpy as np
import pytest
import torch

from bench.tests._tiny import ROOT  # noqa: F401  (puts src on the path)
from bench.cost import bert, decoder_moe, lans
from bench.harness import spec
from bench.harness.program import arch_of
from bench.harness.weights import flatten

BERT = spec.cell("bert-large.p1-seq128").load_config()
GRANITE = spec.cell("granite-moe-3b-a800m-16l.pretrain-seq4096").load_config()


def test_bert_step_flops_by_hand():
    # per token and layer: QKV + output 8 d^2, MLP 4 d ff, attention 4 S d
    per_token_layer = 8 * 1024 ** 2 + 4 * 1024 * 4096 + 4 * 128 * 1024
    assert per_token_layer == 25_690_112
    # per masked token: transform 2 d^2 + decoder 2 d V
    per_masked = 2 * 1024 ** 2 + 2 * 1024 * 30522
    assert per_masked == 64_606_208
    masked = 4915
    batch = {"tokens": np.zeros((256, 128), np.int32),
             "mlm_labels": np.full((256, 128), -100, np.int32)}
    batch["mlm_labels"].reshape(-1)[:masked] = 7
    want = 3 * (24 * 256 * 128 * per_token_layer + masked * per_masked
                + 256 * (2 * 1024 ** 2 + 4 * 1024))
    assert bert.step_flops(BERT, batch) == want
    assert 6.0e13 < want < 6.4e13


def test_granite_step_flops_by_hand():
    proj = 2 * 1536 * (2 * 1536 + 2 * 512)
    attn = 2 * 1536 * 4097            # causal half: (S + 1) / 2 keys
    experts = 8 * 3 * 2 * 1536 * 512
    router = 2 * 1536 * 40
    per_token = 16 * (proj + attn + experts + router) + 2 * 1536 * 49155
    assert per_token == 1_159_652_352
    batch = {"tokens": np.zeros((4, 4096), np.int32)}
    assert decoder_moe.step_flops(GRANITE, batch) == 3 * 4 * 4096 * per_token


@pytest.mark.parametrize("conf", [BERT, GRANITE], ids=["bert", "granite"])
def test_layout_is_the_ports_params(conf):
    ref = spec.kind_module("reference", conf["reference"])
    layout = ref.param_layout(ref.cfg_of(conf))
    arch = arch_of(conf)
    with torch.device("meta"):
        params = flatten(arch.init(None))
    assert {p: tuple(t.shape) for p, t in params.items()} == {
        p: tuple(s) for p, s, _ in layout}


def test_bert_large_parameters_and_update_bytes():
    ref = spec.kind_module("reference", "bert")
    layout = ref.param_layout(ref.cfg_of(BERT))
    n = sum(math.prod(s) for _, s, _ in layout)
    d, V, f = 1024, 30522, 4096
    embed = V * d + 512 * d + 2 * d + 2 * d
    # Q, K, V, O (no output bias), Q/K/V biases, MLP, two LayerNorms
    layer = 4 * d * d + 3 * d + 2 * d * f + f + d + 4 * d
    heads = (d * d + d + 2 * d + V) + (d * d + d) + (2 * d + 2)
    assert n == embed + 24 * layer + heads == 336_201_532
    kept = sum(math.prod(s) for p, s, _ in layout
               if lans.kept_fp32(p, BERT["precision"]["keep_fp32"]))
    # 30 B a bf16 parameter (grad 4, moments 16, master 8, copy 2), 28 B
    # a parameter kept in float32
    assert lans.update_bytes(BERT, layout) == 30 * (n - kept) + 28 * kept


def test_granite_parameters():
    ref = spec.kind_module("reference", "decoder_moe")
    layout = ref.param_layout(ref.cfg_of(GRANITE))
    n = sum(math.prod(s) for _, s, _ in layout)
    per_layer = (1536 * (1536 + 512 + 512) + 1536 * 1536 + 1536 * 40
                 + 3 * 40 * 1536 * 512 + 2 * 1536)
    assert n == 16 * per_layer + 49155 * 1536 + 1536
    assert 1.6e9 < n < 1.8e9
