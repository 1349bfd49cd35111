"""Synthetic token corpus + BERT-style MLM/NSP example construction (a
copy of repro/data/corpus.py, which is numpy only; the port imports
nothing of repro).

The container has no Wikipedia/BooksCorpus; the *pipeline semantics* are
what the paper contributes (§3.4), so the corpus is a deterministic
synthetic token stream with a power-law unigram distribution (to make MLM
learnable) while sharding/shuffling/masking match the real pipeline.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

# Special ids follow the BERT convention.
PAD_ID, CLS_ID, SEP_ID, MASK_ID = 0, 101, 102, 103
FIRST_NORMAL_ID = 110


@dataclasses.dataclass(frozen=True)
class SyntheticCorpus:
    """num_docs documents of doc_len tokens, materialized lazily per doc."""

    vocab: int
    num_docs: int
    doc_len: int
    seed: int = 0
    zipf_a: float = 1.2

    def doc(self, i: int) -> np.ndarray:
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, i]))
        # 75% global zipf tokens (a learnable unigram head for MLM) + 25%
        # doc-"topic" tokens (shifted zipf) so NSP and in-context prediction
        # carry signal too.
        n_normal = self.vocab - FIRST_NORMAL_ID
        z = rng.zipf(self.zipf_a, size=self.doc_len)
        global_tok = FIRST_NORMAL_ID + (z - 1) % n_normal
        shift = rng.integers(0, n_normal)
        topic_tok = FIRST_NORMAL_ID + (z - 1 + shift) % n_normal
        is_topic = rng.random(self.doc_len) < 0.25
        return np.where(is_topic, topic_tok, global_tok).astype(np.int32)


def build_mlm_example(
    corpus: SyntheticCorpus,
    doc_idx: int,
    rng: np.random.Generator,
    *,
    seq_len: int,
    mask_prob: float = 0.15,
) -> Dict[str, np.ndarray]:
    """One BERT pretraining example: [CLS] A [SEP] B [SEP] with 50% random-B
    (NSP negative) and standard 80/10/10 MLM masking."""
    doc = corpus.doc(doc_idx)
    seg = (seq_len - 3) // 2
    a_start = rng.integers(0, max(1, len(doc) - 2 * seg))
    seg_a = doc[a_start:a_start + seg]

    is_next = rng.random() < 0.5
    if is_next:
        seg_b = doc[a_start + seg:a_start + 2 * seg]
    else:
        other = corpus.doc(int(rng.integers(0, corpus.num_docs)))
        b_start = rng.integers(0, max(1, len(other) - seg))
        seg_b = other[b_start:b_start + seg]

    tokens = np.full((seq_len,), PAD_ID, np.int32)
    types = np.zeros((seq_len,), np.int32)
    tokens[0] = CLS_ID
    tokens[1:1 + len(seg_a)] = seg_a
    tokens[1 + len(seg_a)] = SEP_ID
    b0 = 2 + len(seg_a)
    tokens[b0:b0 + len(seg_b)] = seg_b
    tokens[b0 + len(seg_b)] = SEP_ID
    types[b0:b0 + len(seg_b) + 1] = 1

    # MLM masking: 15% of non-special positions; 80% [MASK], 10% random, 10% keep.
    labels = np.full((seq_len,), -100, np.int32)
    maskable = (tokens >= FIRST_NORMAL_ID)
    pick = maskable & (rng.random(seq_len) < mask_prob)
    labels[pick] = tokens[pick]
    r = rng.random(seq_len)
    tokens = np.where(pick & (r < 0.8), MASK_ID, tokens)
    rand_ids = rng.integers(FIRST_NORMAL_ID, corpus.vocab, size=seq_len)
    tokens = np.where(pick & (r >= 0.8) & (r < 0.9), rand_ids, tokens)

    return {
        "tokens": tokens.astype(np.int32),
        "token_types": types,
        "mlm_labels": labels,
        "nsp_labels": np.int32(0 if is_next else 1),
    }


def mlm_batch_iterator(corpus: SyntheticCorpus, spec, *, per_worker_batch: int,
                       seq_len: int, seed: int = 0):
    """Shard-without-replacement batches of BERT pretraining examples.

    ``spec`` is a repro_torch.data.sharding.ShardSpec over corpus.num_docs.
    """
    from repro_torch.data.sharding import minibatches

    rng = np.random.default_rng(np.random.SeedSequence([seed, spec.worker]))
    for idx_batch in minibatches(spec, per_worker_batch):
        exs = [build_mlm_example(corpus, int(i), rng, seq_len=seq_len)
               for i in idx_batch]
        yield {k: np.stack([e[k] for e in exs]) for k in exs[0]}


def lm_batch_iterator(corpus: SyntheticCorpus, spec, *, per_worker_batch: int,
                      seq_len: int):
    """Causal-LM batches (tokens, labels=shift-by-one) for the decoder archs."""
    from repro_torch.data.sharding import minibatches

    for idx_batch in minibatches(spec, per_worker_batch):
        toks = np.stack([corpus.doc(int(i))[:seq_len + 1] for i in idx_batch])
        yield {"tokens": toks[:, :-1].astype(np.int32),
               "labels": toks[:, 1:].astype(np.int32)}
