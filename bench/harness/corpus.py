"""The synthetic corpus and the masked-LM / next-token example makers: a
frozen copy of repro_torch/data/corpus.py (numpy only), so that a change
to the program cannot change the benchmark's inputs.

A document is a deterministic stream of token ids with a power-law
unigram head (75%) and a per-document "topic" shift (25%). A BERT
example is [CLS] A [SEP] B [SEP] with B the next segment or, with
probability `nsp_negative`, a segment of another document, and 80/10/10
masking of `mask_prob` of the ordinary tokens. A next-token example is
the first seq_len + 1 tokens of a document, shifted by one.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

PAD_ID, CLS_ID, SEP_ID, MASK_ID = 0, 101, 102, 103
FIRST_NORMAL_ID = 110


@dataclasses.dataclass(frozen=True)
class SyntheticCorpus:
    vocab: int
    num_docs: int
    doc_len: int
    seed: int = 0
    zipf_a: float = 1.2

    def doc(self, i: int) -> np.ndarray:
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, i]))
        n_normal = self.vocab - FIRST_NORMAL_ID
        z = rng.zipf(self.zipf_a, size=self.doc_len)
        global_tok = FIRST_NORMAL_ID + (z - 1) % n_normal
        shift = rng.integers(0, n_normal)
        topic_tok = FIRST_NORMAL_ID + (z - 1 + shift) % n_normal
        is_topic = rng.random(self.doc_len) < 0.25
        return np.where(is_topic, topic_tok, global_tok).astype(np.int32)


def mlm_example(corpus: SyntheticCorpus, doc_idx: int,
                rng: np.random.Generator, *, seq_len: int,
                mask_prob: float, nsp_negative: float) -> Dict[str, np.ndarray]:
    doc = corpus.doc(doc_idx)
    seg = (seq_len - 3) // 2
    a_start = rng.integers(0, max(1, len(doc) - 2 * seg))
    seg_a = doc[a_start:a_start + seg]
    is_next = rng.random() >= nsp_negative
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

    labels = np.full((seq_len,), -100, np.int32)
    maskable = tokens >= FIRST_NORMAL_ID
    pick = maskable & (rng.random(seq_len) < mask_prob)
    labels[pick] = tokens[pick]
    r = rng.random(seq_len)
    tokens = np.where(pick & (r < 0.8), MASK_ID, tokens)
    rand_ids = rng.integers(FIRST_NORMAL_ID, corpus.vocab, size=seq_len)
    tokens = np.where(pick & (r >= 0.8) & (r < 0.9), rand_ids, tokens)
    return {"tokens": tokens.astype(np.int32), "token_types": types,
            "mlm_labels": labels, "nsp_labels": np.int32(0 if is_next else 1)}


def lm_example(corpus: SyntheticCorpus, doc_idx: int, *,
               seq_len: int) -> Dict[str, np.ndarray]:
    toks = corpus.doc(doc_idx)[:seq_len + 1]
    return {"tokens": toks[:-1].astype(np.int32),
            "labels": toks[1:].astype(np.int32)}
