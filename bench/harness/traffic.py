"""The one generator of training traffic: a mix file (traffic/<mix>.json)
gives the job's shape, this module turns it and a seed into a pool of
global batches on the host.

Keys of a mix file:
  kind          "mlm" (BERT: masked LM + next sentence) or "lm" (next token)
  seq_len       positions a row
  batch         rows a step on each data rank; the global batch is
                batch x the mesh's data size
  microbatches  gradient-accumulation splits of the global batch
  mesh          {"data": n}: the data-parallel ranks (the cell's chips;
                the harness runs n = 1)
  pool_batches  distinct global batches made in set-up, used in turn
  corpus        {"docs", "doc_len", "zipf_a"} of the synthetic corpus
  mask_prob, nsp_negative   (mlm) masking share and NSP negatives
  schedule      the learning-rate schedule of the job (warmup_hold_decay)

Every seed gives the same sizes; only the ids differ. Rows are made from
distinct documents, so that no two rows of the pool are alike.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Dict, List

import numpy as np

from bench.harness import corpus as C


@dataclasses.dataclass(frozen=True)
class Mix:
    name: str
    kind: str
    seq_len: int
    batch: int
    microbatches: int
    data: int
    pool_batches: int
    docs: int
    doc_len: int
    zipf_a: float
    mask_prob: float
    nsp_negative: float
    schedule: dict

    @property
    def global_batch(self) -> int:
        return self.batch * self.data

    @property
    def tokens_per_step(self) -> int:
        return self.global_batch * self.seq_len


def load_mix(path: pathlib.Path) -> Mix:
    raw = json.loads(path.read_text())
    if raw["kind"] not in ("mlm", "lm"):
        raise ValueError(f"{path}: unknown traffic kind {raw['kind']!r}")
    if raw["batch"] * raw["mesh"]["data"] % raw["microbatches"]:
        raise ValueError(f"{path}: the global batch does not split into "
                         f"{raw['microbatches']} microbatches")
    corpus = raw["corpus"]
    return Mix(name=path.stem, kind=raw["kind"], seq_len=raw["seq_len"],
               batch=raw["batch"], microbatches=raw["microbatches"],
               data=raw["mesh"]["data"], pool_batches=raw["pool_batches"],
               docs=corpus["docs"], doc_len=corpus["doc_len"],
               zipf_a=corpus["zipf_a"], mask_prob=raw.get("mask_prob", 0.0),
               nsp_negative=raw.get("nsp_negative", 0.0),
               schedule=raw["schedule"])


def make_pool(mix: Mix, vocab: int, seed: int) -> List[Dict[str, np.ndarray]]:
    """`mix.pool_batches` global batches of numpy arrays, drawn from
    `seed` alone."""
    n_rows = mix.pool_batches * mix.global_batch
    if n_rows > mix.docs:
        raise ValueError(f"{mix.name}: {n_rows} rows need {n_rows} "
                         f"documents, the corpus has {mix.docs}")
    corpus = C.SyntheticCorpus(vocab=vocab, num_docs=mix.docs,
                               doc_len=mix.doc_len, seed=seed,
                               zipf_a=mix.zipf_a)
    rng = np.random.default_rng(np.random.SeedSequence([seed, 1]))
    docs = rng.permutation(mix.docs)[:n_rows]
    if mix.kind == "mlm":
        rows = [C.mlm_example(corpus, int(i), rng, seq_len=mix.seq_len,
                              mask_prob=mix.mask_prob,
                              nsp_negative=mix.nsp_negative) for i in docs]
    else:
        rows = [C.lm_example(corpus, int(i), seq_len=mix.seq_len)
                for i in docs]
    gb = mix.global_batch
    return [{k: np.stack([r[k] for r in rows[b * gb:(b + 1) * gb]])
             for k in rows[0]} for b in range(mix.pool_batches)]
