"""Serving engines (port of repro/serving/engine.py): continuous
batching over a paged or dense pool, the static baseline, sampled and
speculative decoding, the encoder-decoder and BERT families, and the
batch-1 latency mode `run_one`.

`ContinuousEngine` keeps a fixed pool of `max_batch` decode slots. With
the default `cache="paged"` it is backed by a PagedCachePool: attention
KV lives in block arenas addressed through per-slot block tables,
identical prompt prefixes are stored once and shared, and evicted prefix
blocks stay warm on a bounded LRU. With the default `growth="lazy"` only
prompt blocks are allocated at admission and decode blocks grow as each
slot's cursor reaches them; when growth exhausts the arena a victim slot
(the youngest admission) is preempted and re-enters the queue with its
generated tokens as a continuation prefill. `cache="dense"` keeps the
per-slot-rows CachePool (the differential baseline). Admission is fifo
and batched: one left-padded prefill per padded-length bucket (group
sizes padded to powers of two). One decode step advances every active
slot per iteration; on the paged pool its attention runs the
hand-written kernel (`attn_kernel="paged"`) or the plain-torch gather
(`"xla"`).

`ServeEngine` is the static baseline: one padded prefill of the whole
batch, then lockstep decode for max(max_new_tokens) steps.

Sampling (`sampler`): temperature / top-k / top-p with per-token PRNG
keys fold(fold(PRNGKey(seed), rid), token index) — a pure function of
(seed, request id, token index), so a sampled stream does not depend on
slot placement, admission order or batch-mates (serving/sampler.py).

Speculative decoding (`spec_draft=(draft_arch, draft_params)`,
`spec_k=K`): every decode iteration is a draft-verify round. The draft
(its own dense CachePool, prefilled at admission beside the target) runs
K micro-steps proposing d_1..d_K; the target verifies them in one step
of S = K query rows per slot ([t0, d_1..d_{K-1}], which on the kernel
path is one K8 launch per layer) and emits y_1..y_K. The leading run of
a agreements yields min(a + 1, K, budget) tokens, each the target's
pick given an all-accepted context, so the stream equals non-speculative
decoding token for token (sampled too: row i draws with the key of token
emitted + i). A round where some slot emitted fewer than K rolls both
pools back: cursors rewind and the stale rows' positions drop to -1.
The paged rings carry a K - 1 row margin (models/decoder.paged_layout).

Chunked prefill (`chunk_budget=N`, paged pool only, not with a draft):
admission starts at most one prefill task at a time and advances it by
one chunk per step, sized so that chunk rows + decoding slots <= N
(serving/admission.py); the chunks run eagerly against the task's own
dense cache (no paged kernel), and the decode step between them is the
usual one. The task's slot stays out of the decode batch until its
last chunk lands and its cache is inserted (share=False: chunked blocks
are never content-addressed). The admission gate holds back one block
per decoding slot on top of the pool's watermark, since the blocks are
taken only at the insert; an insert that still finds the arena short
requeues the request, and the continuation re-chunks identically.

Every decoder family serves: dense, MoE (routed dropless) and the
Mamba-2 and hybrid ones, whose SSM state stays slot-resident in both
pools (their prompts pad to a multiple of the SSD chunk,
`prompt_granularity`).

Encoder-decoder (`task="generate"` on an encdec arch, paged cache only):
each request carries its encoder input (`Request.frames`). Admission
prefills a group in one call that runs the encoder, projects the cross
K/V once and prefills the decoder prompt; each request's cross K/V then
land in (or share, or revive) refcounted blocks of the
EncDecCachePool's cross arena, keyed by the input's bytes, and every
decode step reads them through the block-table gather.

BERT (`task="score"` or `"embed"`): no cache and no decode loop. A step
admits up to max_batch queued requests, runs one (max_batch, max_len)
forward (short batches replicate their last row) and completes them
all: `Request.embedding` gets the tanh-pooled [CLS] vector and, scoring,
`generated` the masked-LM argmax of each prompt position.

`run_one` serves one request at batch 1, outside the scheduler and the
pool: the same prefill, sampler keys and left-pad masking, and for
encdec the dense cross K/V padded to the arena's blocked length, so
that its output is the pooled engine's.

On a mesh (`mesh=`, a DeviceMesh of ("data", "model") from
launch/mesh.py:make_local_mesh) the engine runs as one process per rank
of a torch.distributed group (gloo on the CPU and for ranks that share
a card, NCCL with a card per rank), where JAX serves from one
controller over sharded arrays:
  * every rank runs this same engine loop on the same requests, so the
    scheduler, the block bookkeeping and admission decide alike
    everywhere;
  * what differs is which slots' rows, which arena blocks and which heads
    live on each rank (distributed/sharding.py: ServeLayout; the same
    placement as PSpecs, serve_pspec): the slots are cut over "data" in
    blocks, each rank decoding its own block against its own share of
    each arena (a null block of its own, local block ids; prefix sharing
    and the retained LRU within a share); over "model" each rank
    computes on what the training step's model axis computes on
    (serve_params): its heads (and n_kv / model KV heads of every cache,
    where the model axis cuts attention on whole heads; n_kv / d, the
    same on each of a head group's ranks, where it cuts it in d groups:
    distributed/sharding.py: head_groups; elsewhere attention runs
    whole on every model rank), its ff columns, its
    experts, its vocab rows and its Mamba-2 heads (and their SSM state
    and conv channels in the pools);
  * where the vocab is cut, each rank's logits are its columns, and
    every pick (the decode and verify steps', the first token after a
    prefill or a chunked admission, BERT's MLM ids) is the whole row's,
    taken over "model" (serving/sampler.py: VocabCut);
  * after each decode step the picked tokens are gathered over "data",
    so every rank's host loop sees all of them, and with them each
    rank's flag of non-finite logits (summed over "model" too), so
    every rank counts a step whose logits held a NaN or inf in any slot
    or column (distributed/steps.py);
  * every clock read of the loop (submit and admission times, the
    policy's `now`, the times of tokens and completions) is rank 0's
    time.perf_counter, broadcast (distributed/steps.py: shared_clock),
    so that SLO eviction and the deadline policy decide alike on every
    rank; an open-loop driver takes the same clock (`clock`) for its
    arrivals;
  * an admitted group is prefilled whole on every rank, at one device's
    padding and row count, and each rank keeps its slots' rows;
  * slots that do not divide over "data" are whole on every data rank:
    each holds and decodes all of them, as one device does (JAX's cache
    rule keeps such a cache whole on the data axis), and counts each
    once;
  * run_one serves its one request at batch 1 on every rank, so whole
    on every data rank, each model rank on its cut;
  * a mesh never falls back to one device: a process group of the wrong
    size, or none, raises (launch/mesh.py).
A data mesh gives one device's bits under every policy; a model mesh
splits each attention, MLP, expert and Mamba matmul and sums the parts
in rank order (distributed/partial.py), so fp32 tokens equal one
device's. ServeEngine takes `mesh` and never shards.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.optim.base import tree_leaves, tree_map
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.steps import (build_prefill_step,
                                           build_serve_step,
                                           build_verify_step, gather_slots,
                                           greedy_next, serving_ambient,
                                           shared_clock)
from repro_torch.serving.admission import (AdmissionController,
                                           chunk_granularity)
from repro_torch.serving.block_allocator import NoBlocksError
from repro_torch.serving.cache_pool import (CachePool, EncDecCachePool,
                                            PagedCachePool)
from repro_torch.serving.metrics import DepthTracker, RequestTrace, aggregate
from repro_torch.serving.sampler import (Sampler, fold_keys, nonfinite,
                                         vocab_cut)
from repro_torch.serving.scheduler import (PolicyContext, Scheduler,
                                           SchedulingPolicy)


@dataclasses.dataclass
class Request:
    """One serving request: a prompt and a generation budget. The engine
    fills `generated` ((n,) int32, n <= max_new_tokens) on completion,
    `rid` at submit (it seeds the sampler's request key), and `trace`
    with submit/admit/token timestamps.

    Family extras: `frames` is the encoder input of an encdec request
    ((n_frames, d_model) float32, required there); a bert engine fills
    `embedding` with the fp32 tanh-pooled [CLS] vector (task "score"
    also fills `generated` with the masked-LM argmax per position)."""
    prompt: np.ndarray          # (prompt_len,) int32
    max_new_tokens: int = 16
    generated: Optional[np.ndarray] = None
    rid: Optional[int] = None
    trace: RequestTrace = dataclasses.field(default_factory=RequestTrace)
    frames: Optional[np.ndarray] = None      # encdec encoder input
    embedding: Optional[np.ndarray] = None   # bert pooled [CLS] output


def apply_serving_policy(arch, params, policy=None):
    """Inference-side precision and MoE policy of an (arch, params) pair.

    policy (optional name or Policy): cast the parameter copy per the
    policy (its keep_fp32 leaves, norms and biases, stay fp32) and run
    compute in its compute dtype. MoE archs are served dropless:
    capacity_factor = n_experts makes cap = tokens * top_k, so no token
    is dropped and routing does not depend on the batch's make-up
    (continuous == static, padded == unpadded), as in the JAX package."""
    cfg = arch.cfg
    if policy is not None:
        from repro_torch.precision import get_policy
        policy = get_policy(policy)
        cfg = policy.apply_to_cfg(cfg)
        params = policy.cast_params(params)
    if getattr(cfg, "n_experts", 0):
        cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts))
    if cfg is not arch.cfg:
        arch = dataclasses.replace(arch, cfg=cfg)
    return arch, params


def prompt_granularity(cfg) -> int:
    """Smallest prefill length multiple the arch supports: mamba's chunked
    scan needs S % chunk == 0; attention takes any length."""
    if any(m == "mamba" for m, _ in getattr(cfg, "superblock", ())):
        return int(cfg.mamba_chunk)
    return 1


def build_prefill_fn(arch, max_len: int, kv_heads: Optional[int] = None,
                     mamba_ranks: int = 1):
    """(params, tokens, positions) -> (fp32 last-position logits
    (B, 1, V), pooled cache of max_len rows, holding kv_heads KV heads
    (default all) and the Mamba state of the heads of one of mamba_ranks
    ranks (ServeLayout.cache_kw))."""
    @torch.no_grad()
    def prefill(params, tokens, positions):
        logits, cache = arch.prefill(params, {"tokens": tokens},
                                     cache_len=max_len, positions=positions,
                                     kv_heads=kv_heads,
                                     mamba_ranks=mamba_ranks)
        return logits.float(), cache
    return prefill


def build_encdec_prefill_fn(arch, max_len: int,
                            kv_heads: Optional[int] = None):
    """(params, tokens, positions, frames) -> (fp32 last-position logits,
    cache): one pass runs the encoder over the frames and the masked
    decoder prefill over the prompt; the cache holds the per-slot self
    rows and, under "cross", the dense per-layer cross K/V that the pool
    registers as arena blocks."""
    @torch.no_grad()
    def prefill(params, tokens, positions, frames):
        logits, cache = arch.prefill(
            params, {"tokens": tokens, "frames": frames},
            cache_len=max_len, positions=positions, kv_heads=kv_heads)
        return logits.float(), cache
    return prefill


def _score_step(arch, mesh, layout):
    """(params, tokens, positions) -> (MLM ids, pooled vectors) of the
    whole (max_batch, S) batch: arch.score, and on a mesh each rank
    scoring its rows (a model axis computing its heads and ff columns),
    the outputs gathered over "data"."""
    score = torch.no_grad()(arch.score)
    if mesh is None:
        return score

    def step(params, tokens, positions):
        with serving_ambient(mesh):
            ids, pooled = score(params, layout.local_rows(tokens),
                                layout.local_rows(positions, -1))
        return (gather_slots(ids, layout, mesh),
                gather_slots(pooled, layout, mesh))
    return step


def build_first_token_fn(sampler: Optional[Sampler], cut=None):
    """(first-token fn, wants_keys). Greedy unless a non-greedy sampler
    is given; the sampled variant takes (logits, keys (B, 2)). A greedy
    sampler with stable_tiebreak picks through its one-ulp-band argmax.
    cut: the rank's vocab-parallel logit columns on a serving mesh
    (serving/sampler.py: VocabCut), whose picks are the whole rows'."""
    if sampler is None or sampler.greedy:
        if sampler is not None and sampler.stable_tiebreak:
            return (lambda logits: sampler.sample(logits[:, -1, :], cut=cut),
                    False)
        return (lambda logits: greedy_next(logits, cut)), False
    return (lambda logits, keys: sampler.sample(logits[:, -1, :], keys,
                                                cut), True)


def first_tokens(first_fn, sampler: Optional[Sampler], wants_keys: bool,
                 logits, requests, token_idx=None):
    """Prefill logits -> (first token per request (B,) np.int32, request
    base keys (B, 2) np.uint32 or None). A sampled first token draws with
    the request's token-`token_idx` key (0 for a fresh admission; a
    preempted request's continuation passes the tokens it already has).
    The one definition both engines use, so their keys agree."""
    if not wants_keys:
        return first_fn(logits).cpu().numpy(), None
    rkeys = np.stack([sampler.request_key(r.rid) for r in requests])
    tvec = (np.zeros(len(requests), np.int32) if token_idx is None
            else np.asarray(token_idx, np.int32))
    toks = first_fn(logits, fold_keys(rkeys, tvec))
    return toks.cpu().numpy(), rkeys


def synthetic_requests(n: int, vocab: int, *, prompt_len: int,
                       new_tokens: int, seed: int = 0,
                       min_new_frac: float = 0.5, shared_prefix: int = 0):
    """Load-generator workload: prompt lengths in [prompt_len/2,
    prompt_len], budgets in [new_tokens*min_new_frac, new_tokens], and
    an optional common prefix. A pure function of the arguments, drawn
    exactly as the JAX package draws it, so both engines see
    byte-identical requests."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(5, vocab, size=shared_prefix).astype(np.int32)
    reqs = []
    for _ in range(n):
        plen = int(rng.integers(max(1, prompt_len // 2), prompt_len + 1))
        new = int(rng.integers(max(1, int(new_tokens * min_new_frac)),
                               new_tokens + 1))
        tail = rng.integers(5, vocab, size=plen).astype(np.int32)
        reqs.append(Request(prompt=np.concatenate([prefix, tail]),
                            max_new_tokens=new))
    return reqs


def synthetic_scoring_requests(n: int, vocab: int, *, prompt_len: int,
                               seed: int = 0):
    """Scoring/embedding workload: prompt lengths in [prompt_len/2,
    prompt_len]; max_new_tokens=1 is inert (scoring completes at
    admission). Drawn exactly as the JAX package draws it."""
    rng = np.random.default_rng(seed)
    reqs = []
    for _ in range(n):
        plen = int(rng.integers(max(1, prompt_len // 2), prompt_len + 1))
        reqs.append(Request(
            prompt=rng.integers(5, vocab, size=plen).astype(np.int32),
            max_new_tokens=1))
    return reqs


def synthetic_encdec_requests(n: int, vocab: int, *, n_frames: int,
                              d_model: int, prompt_len: int,
                              new_tokens: int,
                              n_inputs: Optional[int] = None,
                              seed: int = 0):
    """Encoder-decoder workload: each request carries an encoder input
    (`frames`), a decoder prompt and a budget. n_inputs < n reuses the
    inputs round-robin: beams or retries of one utterance, whose encoder
    blocks the cross arena stores once. Drawn exactly as the JAX package
    draws it."""
    rng = np.random.default_rng(seed)
    n_inputs = n if n_inputs is None else n_inputs
    frames = [rng.standard_normal((n_frames, d_model)).astype(np.float32)
              for _ in range(n_inputs)]
    reqs = []
    for i in range(n):
        plen = int(rng.integers(max(1, prompt_len // 2), prompt_len + 1))
        new = int(rng.integers(max(1, new_tokens // 2), new_tokens + 1))
        reqs.append(Request(
            prompt=rng.integers(5, vocab, size=plen).astype(np.int32),
            max_new_tokens=new, frames=frames[i % n_inputs]))
    return reqs


def make_spec_pair(arch, params):
    """Speculative fixture with acceptance 1.0 by construction: returns
    (target_params, draft_arch, draft_params), where the target's periods
    above the first are made inert (attention out-projection and MLP
    down-projection zeroed, so both residual branches add exactly 0) and
    the draft is the same config cut to one period, sharing the
    embedding, final norm and the bottom period's weights. The doctored
    target computes the draft's function, so every proposal is accepted.
    Attention/MLP superblocks only."""
    cfg = arch.cfg
    if cfg.n_periods < 2:
        raise ValueError(f"need >= 2 periods to truncate, got "
                         f"{cfg.n_periods}")
    for mixer, ffn in cfg.superblock:
        if mixer not in ("attn", "attn_local") or ffn != "mlp":
            raise ValueError(f"make_spec_pair supports attn/mlp "
                             f"superblocks only, got ({mixer}, {ffn})")

    def inert_upper(a):        # zero periods 1.. of an output projection
        a = a.clone()
        a[1:] = 0
        return a

    target_params = dict(params)
    draft_params = {"embed": params["embed"],
                    "final_norm": params["final_norm"]}
    for si in range(len(cfg.superblock)):
        slot = dict(params[f"slot{si}"])
        slot["mixer"] = {**slot["mixer"],
                         "wo": tree_map(inert_upper, slot["mixer"]["wo"])}
        slot["ffn"] = {**slot["ffn"],
                       "down": tree_map(inert_upper, slot["ffn"]["down"])}
        target_params[f"slot{si}"] = slot
        draft_params[f"slot{si}"] = tree_map(lambda a: a[:1],
                                             params[f"slot{si}"])
    draft_arch = dataclasses.replace(
        arch, cfg=dataclasses.replace(cfg, n_layers=len(cfg.superblock)))
    return target_params, draft_arch, draft_params


def pad_prompts(prompts: List[np.ndarray], granularity: int = 1,
                pad_len: Optional[int] = None):
    """Left-pad to a common length -> (tokens, positions, lengths).
    Positions are per-request LOCAL timelines (negative for padding)."""
    lens = np.array([len(p) for p in prompts], np.int32)
    plen = pad_len if pad_len is not None else int(lens.max())
    plen = -(-plen // granularity) * granularity
    if plen < int(lens.max()):
        raise ValueError(f"pad_len {plen} < longest prompt {lens.max()}")
    B = len(prompts)
    tokens = np.zeros((B, plen), np.int32)
    positions = np.empty((B, plen), np.int32)
    for i, p in enumerate(prompts):
        tokens[i, plen - len(p):] = p
        positions[i] = np.arange(plen) - (plen - len(p))
    return tokens, positions, lens


def _slice_request(cache, g: int):
    """Batch row g of a batched-prefill cache as a batch-1 cache (the
    decoder's tuple of slot caches or the encdec's {"self": ...})."""
    def rows(s):
        return {k: v[:, g:g + 1] for k, v in s.items()}
    slots = cache["slots"]
    return {"slots": ({n: rows(s) for n, s in slots.items()}
                      if isinstance(slots, dict)
                      else tuple(rows(s) for s in slots)),
            "index": cache["index"][g:g + 1]}


class ContinuousEngine:
    """Continuous-batching decode over a fixed slot pool (paged by
    default; `cache="dense"` for the per-slot-rows baseline)."""

    def __init__(self, arch, params, *, max_batch: int = 8,
                 max_len: int = 256, policy=None, mesh=None,
                 prefill_bucket: int = 1,
                 on_step=None, cache: str = "paged", block_size: int = 16,
                 slots_budget: Optional[int] = None,
                 share_prefix: bool = True, sampler=None,
                 attn_kernel: Optional[str] = None,
                 kernel_interpret: bool = False,
                 growth: str = "lazy",
                 sched_policy="fifo", slo_ms: Optional[float] = None,
                 preempt: bool = True, retain_blocks: Optional[int] = None,
                 watermark: int = 0, spec_draft=None, spec_k: int = 4,
                 chunk_budget: Optional[int] = None,
                 task: str = "generate"):
        """Args as the JAX engine's. Caches live on the device of the
        params. mesh: a serving mesh (the module docstring), every rank
        passing the same whole params. cache "paged" or "dense";
        attn_kernel "paged" runs the hand-written kernel, "xla" the
        plain-torch gather (paged pool only), None adopts
        arch.cfg.attn_kernel; kernel_interpret=True (with "paged" only)
        runs the kernel's plain version on any device, launching
        nothing (JAX's Pallas interpret mode).
        spec_draft=(draft_arch, draft_params) enables speculative
        decoding with spec_k (>= 2) tokens per round; it needs the paged
        pool and attention-only superblocks on both models.
        chunk_budget=N admits prompts chunk by chunk within N tokens per
        step (paged pool only; prefill_bucket rounds up to the chunk
        granularity). task: "generate" (decoder and encdec archs; encdec
        needs cache="paged", its cross arena, and takes none of
        attn_kernel="paged", chunk_budget and spec_draft), or "score" /
        "embed" (bert archs: one fixed-shape forward per step, max_len
        at most the position table)."""
        if task not in ("generate", "score", "embed"):
            raise ValueError(
                f"task must be 'generate', 'score' or 'embed', got {task!r}")
        if arch.kind == "bert":
            if task == "generate":
                raise ValueError(
                    "bert archs serve scoring/embedding, not generation: "
                    "pass task='score' or task='embed'")
        elif arch.kind in ("decoder", "encdec"):
            if task != "generate":
                raise ValueError(
                    f"task={task!r} needs a bert arch, got {arch.kind!r}")
        else:
            raise ValueError(f"cannot serve arch kind {arch.kind!r}")
        self.task = task
        self.encdec = arch.kind == "encdec"
        self.bert = arch.kind == "bert"
        if arch.kind != "decoder":
            if chunk_budget is not None:
                raise ValueError(
                    f"chunk_budget is decoder-only, got arch kind "
                    f"{arch.kind!r}")
            if spec_draft is not None:
                raise ValueError(
                    f"spec_draft is decoder-only, got arch kind "
                    f"{arch.kind!r}")
            if attn_kernel == "paged":
                raise ValueError(
                    "attn_kernel='paged' is decoder-only: the encdec "
                    "cross arena reads through the dense XLA gather")
        if self.encdec and cache != "paged":
            raise ValueError(
                "encdec serving requires cache='paged': the encoder "
                "output lives in the shared cross-attention block arena")
        if cache not in ("paged", "dense"):
            raise ValueError(f"cache must be 'paged' or 'dense', got {cache}")
        if growth not in ("lazy", "eager"):
            raise ValueError(f"growth must be 'lazy' or 'eager', got {growth}")
        if attn_kernel is None:
            attn_kernel = getattr(arch.cfg, "attn_kernel", "xla")
        if attn_kernel not in ("xla", "paged"):
            raise ValueError(
                f"attn_kernel must be 'xla' or 'paged', got {attn_kernel}")
        if attn_kernel == "paged" and cache != "paged":
            raise ValueError("attn_kernel='paged' requires cache='paged' "
                             "(the dense pool has no block tables)")
        if kernel_interpret and attn_kernel != "paged":
            raise ValueError(
                "kernel_interpret only applies to attn_kernel='paged' "
                "(the XLA gather path has no kernel to interpret)")
        self.spec = spec_draft is not None
        if self.spec:
            if spec_k < 2:
                raise ValueError(f"spec_k must be >= 2, got {spec_k}")
            if cache != "paged":
                raise ValueError(
                    "speculative decoding requires cache='paged' "
                    "(rollback and the row margin are paged-pool features)")
            if chunk_budget is not None:
                raise ValueError("speculative decoding and chunked "
                                 "prefill are mutually exclusive")
            draft_arch, draft_params = spec_draft
            for who, a in (("target", arch), ("draft", draft_arch)):
                if any(m == "mamba" for m, _ in a.cfg.superblock):
                    raise ValueError(
                        f"speculative decoding needs an attention-only "
                        f"{who}: SSM state cannot be stepped S=K "
                        f"(target) or rewound on rejection (draft)")
            if draft_arch.cfg.vocab != arch.cfg.vocab:
                raise ValueError(
                    f"draft vocab {draft_arch.cfg.vocab} != target "
                    f"vocab {arch.cfg.vocab}")
        self.spec_k = spec_k if self.spec else 1
        self.arch, self.params = apply_serving_policy(arch, params, policy)
        if arch.kind == "decoder" and (
                attn_kernel != self.arch.cfg.attn_kernel
                or kernel_interpret != bool(self.arch.cfg.kernel_interpret)):
            self.arch = dataclasses.replace(self.arch, cfg=dataclasses.replace(
                self.arch.cfg, attn_kernel=attn_kernel,
                kernel_interpret=kernel_interpret))
        self.mesh = mesh
        self.layout = shd.serve_layout(arch.heads, max_batch, mesh,
                                       arch.mamba)
        # the rank's vocab-parallel logit columns, where the model axis
        # cuts the vocab: every pick and non-finite flag spans "model"
        self._vocab = None
        if mesh is not None:
            self.params = shd.serve_params(self.params, mesh, arch.heads,
                                           arch.mamba)
            self._vocab = vocab_cut(mesh, self.params)
        cache_kw = self.layout.cache_kw(arch.heads[1])
        self.device = tree_leaves(self.params)[0].device
        # every clock read of the engine loop: on a mesh rank 0's, so that
        # the decisions that read it come out alike on every rank
        self.clock = shared_clock(mesh, self.device)
        self.max_batch = max_batch
        self.max_len = max_len
        self.paged = cache == "paged" and arch.kind == "decoder"
        self.sampler = Sampler.parse(sampler)
        self.prefill_bucket = max(prefill_bucket,
                                  prompt_granularity(self.arch.cfg))
        self.chunk_budget = chunk_budget
        if chunk_budget is not None:
            if not self.paged:
                raise ValueError(
                    "chunk_budget requires cache='paged': the chunked "
                    "prefill cache is unclamped (full-length sliding-"
                    "window rows) and only the paged insert can take "
                    "its window tail")
            # padded prompt lengths must divide into chunk-granularity
            # multiples or the final chunk could be unreachable
            g = chunk_granularity(self.arch.cfg)
            self.prefill_bucket = -(-self.prefill_bucket // g) * g
        if retain_blocks is None:
            # one BATCH's worth of blocks: a multi-tenant set of hot
            # prefixes thrashes an LRU of one request's worth (the
            # encdec pool caps it at its cross arena's size)
            retain_blocks = max(1, max_batch * (max_len // block_size))
        if self.bert:
            # no cache: a scoring slot's only state is its output, and one
            # (max_batch, max_len) forward is the whole step
            if max_len > self.arch.cfg.max_pos:
                raise ValueError(
                    f"max_len {max_len} exceeds the bert position table "
                    f"({self.arch.cfg.max_pos})")
            self.pool = None
            self.score_len = max_len
        elif self.encdec:
            self.pool = EncDecCachePool(
                self.arch, max_batch, max_len, block_size=block_size,
                slots_budget=slots_budget, share_prefix=share_prefix,
                retain_blocks=retain_blocks, device=self.device, mesh=mesh)
            self._prefill_len = max_len
        elif self.paged:
            self.pool = PagedCachePool(
                self.arch, max_batch, max_len, block_size=block_size,
                slots_budget=slots_budget, share_prefix=share_prefix,
                attn_kernel=attn_kernel, growth=growth, retain_blocks=retain_blocks,
                watermark=watermark, row_margin=self.spec_k - 1,
                device=self.device, mesh=mesh)
            # slack rows so the padded prompt never reaches the request
            # cache's last row, which stays pos=-1 (the insert's filler)
            self._prefill_len = max_len + max(block_size,
                                              self.prefill_bucket)
        else:
            self.pool = CachePool(self.arch, max_batch, max_len,
                                  device=self.device, mesh=mesh)
            self._prefill_len = max_len
        self.scheduler = Scheduler(max_batch)
        slo_s = slo_ms / 1e3 if slo_ms is not None else None
        self.sched_policy = SchedulingPolicy.parse(sched_policy, slo_s=slo_s)
        self.preempt_enabled = preempt
        self.on_step = on_step
        # steps (prefill or decode) whose fp32 logits held a NaN or inf,
        # counted on the device and read only by report()
        self._nonfinite = torch.zeros((), dtype=torch.int64,
                                      device=self.device)
        # the steps close over the arch and the counter, never over the
        # engine: a dropped engine then holds no reference cycle, and its
        # pools are freed at once, without the collector
        if self.bert:
            self._score = _score_step(self.arch, mesh, self.layout)
            self._step = self._prefill = None
        else:
            self._score = None
            self._step = build_serve_step(
                self.arch.decode_step, mesh, sampler=self.sampler,
                layout=self.layout, nonfinite=self._nonfinite,
                vocab=self._vocab)
            self._prefill = build_prefill_step(
                build_encdec_prefill_fn(self.arch, self._prefill_len,
                                        cache_kw["kv_heads"])
                if self.encdec
                else build_prefill_fn(self.arch, self._prefill_len,
                                      **cache_kw),
                mesh)
        self._first, self._wants_keys = build_first_token_fn(self.sampler,
                                                             self._vocab)
        self._one_steps = None          # run_one's on a mesh: _one()
        self._admission = None
        if chunk_budget is not None:
            self._admission = AdmissionController(
                self.arch, self.params, chunk_budget=chunk_budget,
                prefill_len=self._prefill_len, mesh=mesh)
        if self.spec:
            self.draft_arch, self.draft_params = apply_serving_policy(
                draft_arch, draft_params, policy)
            dheads = self.draft_arch.heads
            draft_vocab = None
            if mesh is not None:
                self.draft_params = shd.serve_params(
                    self.draft_params, mesh, dheads, self.draft_arch.mamba)
                draft_vocab = vocab_cut(mesh, self.draft_params)
            self.draft_pool = CachePool(self.draft_arch, max_batch, max_len,
                                        device=self.device, mesh=mesh)
            self._draft_prefill = build_prefill_step(build_prefill_fn(
                self.draft_arch, max_len,
                **self.draft_pool.layout.cache_kw(dheads[1])), mesh)
            self._draft_step = build_serve_step(
                self.draft_arch.decode_step, mesh, sampler=self.sampler,
                layout=self.draft_pool.layout, vocab=draft_vocab)
            self._verify = build_verify_step(
                self.arch.decode_step, mesh, sampler=self.sampler,
                layout=self.layout, nonfinite=self._nonfinite,
                vocab=self._vocab)
            # host mirror of the draft pool's write cursors (PADDED rows,
            # unlike _positions' local timeline)
            self._draft_rows = np.zeros(max_batch, np.int64)
            self.spec_rounds = 0
            self.drafted_tokens = 0     # proposals verified
            self.accepted_tokens = 0    # proposals the target agreed with
        self._tokens = np.zeros((max_batch, 1), np.int32)
        self._positions = np.full((max_batch, 1), -1, np.int32)
        self._req_keys = np.zeros((max_batch, 2), np.uint32)
        self._emitted: Dict[int, list] = {}     # slot -> generated ids
        self._resume: Dict[int, list] = {}      # rid -> preempted tokens
        self._admit_seq: Dict[int, int] = {}
        self._admit_time: Dict[int, float] = {}
        self._admit_counter = 0
        self._depth = DepthTracker()
        self._next_rid = 0
        self.steps_run = 0
        self.slot_steps = 0
        self.max_concurrent = 0
        self.preemptions = 0

    # ---------------- request lifecycle ----------------

    def submit(self, request: Request):
        """Queue a request; it must fit max_len (prompt + budget; a
        scoring prompt alone), and an encdec request must carry frames of
        n_frames rows."""
        if self.bert:
            if not 1 <= len(request.prompt) <= self.score_len:
                raise ValueError(
                    f"scoring prompt length {len(request.prompt)} must "
                    f"be in [1, {self.score_len}]")
            self._stamp(request)
            return
        if self.encdec:
            if request.frames is None:
                raise ValueError(
                    "encdec requests need `frames` (the encoder input)")
            nf = self.arch.cfg.n_frames
            if np.asarray(request.frames).shape[0] != nf:
                raise ValueError(
                    f"frames must carry {nf} rows, got "
                    f"{np.asarray(request.frames).shape[0]}")
        if len(request.prompt) + request.max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt {len(request.prompt)} + max_new_tokens "
                f"{request.max_new_tokens} exceeds max_len {self.max_len}")
        if request.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        self._stamp(request)

    def _stamp(self, request: Request):
        """Give the request its id and submit time, and queue it."""
        self._assign_rid(request)
        request.trace.mark_submit(self.clock())
        self.scheduler.submit(request)

    def _assign_rid(self, request: Request):
        if request.rid is None:
            request.rid = self._next_rid
            self._next_rid += 1

    def _release(self, slot: int):
        """Free the slot's cache rows (both pools) and mark it inactive:
        position -1 sends its decode writes nowhere."""
        self.pool.evict(slot)
        if self.spec:
            self.draft_pool.evict(slot)
            self._draft_rows[slot] = 0
        self._admit_seq.pop(slot, None)
        self._admit_time.pop(slot, None)
        self._positions[slot, 0] = -1
        self._tokens[slot, 0] = 0

    def _finish(self, slot: int):
        req = self.scheduler.complete(slot)
        req.generated = np.array(self._emitted.pop(slot), np.int32)
        req.trace.done_t = self.clock()
        self._release(slot)
        return req

    def _count_nonfinite(self, logits):
        self._nonfinite += nonfinite(logits, self._vocab)

    def _resume_of(self, req: Request) -> list:
        return self._resume.get(req.rid, [])

    def _full_prompt(self, req: Request) -> np.ndarray:
        """The prompt an admission prefills: the original prompt plus the
        tokens generated before a preemption."""
        resume = self._resume_of(req)
        prompt = np.asarray(req.prompt, np.int32)
        if not resume:
            return prompt
        return np.concatenate([prompt, np.asarray(resume, np.int32)])

    def _plen(self, req: Request) -> int:
        return len(req.prompt) + len(self._resume_of(req))

    def _padded_len(self, req: Request) -> int:
        plen = max(self._plen(req), 1)
        return -(-plen // self.prefill_bucket) * self.prefill_bucket

    def _decode_slots(self) -> list:
        """Active slots that decode this step: every scheduler-active
        slot except the one bound to an in-flight chunked-prefill task
        (it holds no pool blocks yet, its position is -1, and growth,
        preemption and SLO eviction must not see it until its insert).
        Without a controller this is sorted(scheduler.active)."""
        skip = None
        if self._admission is not None and self._admission.task is not None:
            skip = self._admission.task.slot
        return sorted(s for s in self.scheduler.active if s != skip)

    def _policy_ctx(self, warm_cache: Optional[dict] = None
                    ) -> PolicyContext:
        """Snapshot for the scheduling policy. Under chunked admission a
        preemption's continuation is metered chunk work, so the policy
        gets its exact size (resume_cost) for the base victim rule.

        On a paged pool with attention the snapshot carries the pool's
        warm-prefix probe (prefix_warm; None otherwise). warm_cache
        (rid -> bool) memoizes its sha256 probes over the iterations of
        one admission pass: an answer holds within a pass (admissions
        only add warmth, and a stale False falls back to arrival order),
        so a pass probes each queued request once."""
        warm = None
        if self.paged and self.pool.maps:
            def warm(req):
                if warm_cache is not None and req.rid in warm_cache:
                    return warm_cache[req.rid]
                w = self.pool.prefix_warm(self._full_prompt(req),
                                          self._plen(req),
                                          self._padded_len(req))
                if warm_cache is not None:
                    warm_cache[req.rid] = w
                return w
        resume_cost = None
        if self._admission is not None:
            def resume_cost(slot):
                req = self.scheduler.active.get(slot)
                if req is None:
                    return 0
                return len(req.prompt) + len(self._emitted.get(slot, ()))
        return PolicyContext(now=self.clock(),
                             admit_seq=self._admit_seq,
                             admit_t=self._admit_time,
                             active=self.scheduler.active,
                             submit_t=lambda r: r.trace.submit_t,
                             prefix_warm=warm, resume_cost=resume_cost)

    def _fits(self, req: Request, pending: dict):
        """Would this request's block plan fit beside the admissions
        already planned in this pass, in the share of the slot it would
        get? (The dense pool always fits; an encdec request plans its
        cross blocks.)"""
        slot = self.scheduler.next_free
        if self.encdec:
            need = self.pool.admission_plan(
                np.asarray(req.frames, np.float32), slot=slot)
        elif not self.paged:
            return True, None
        else:
            budget = req.max_new_tokens - len(self._resume_of(req))
            need = self.pool.admission_plan(self._full_prompt(req),
                                            self._plen(req),
                                            self._padded_len(req), budget,
                                            slot=slot)
        avail = self.pool.admissible_blocks(slot)
        ok = all(n + pending.get(si, 0) <= avail[si]
                 for si, n in need.items())
        return ok, need

    def _admit(self):
        """Fill free slots from the queue in policy order: one batched
        prefill per padded-length bucket (the draft prefills the same
        group), then each cache row is inserted into its slot."""
        while True:
            pairs, pending, warm_cache = [], {}, {}
            while self.scheduler.free_slots and self.scheduler.queued:
                i = self.sched_policy.pick(
                    self.scheduler.queue_items(),
                    self._policy_ctx(warm_cache=warm_cache))
                req = self.scheduler.peek(i)
                ok, need = self._fits(req, pending)
                if not ok:
                    break   # head of line waits for evictions
                for si, n in (need or {}).items():
                    pending[si] = pending.get(si, 0) + n
                pairs.append(self.scheduler.assign_at(i))
            if not pairs:
                return
            groups: Dict[int, list] = {}
            for slot, req in pairs:
                groups.setdefault(self._padded_len(req), []).append(
                    (slot, req))
            failed = []
            for padded, grp in groups.items():
                prompts = [self._full_prompt(r) for _, r in grp]
                # pad the group to a power-of-two size by replicating its
                # last request (outputs discarded), as the JAX engine does
                n = len(grp)
                n_pad = 1 << (n - 1).bit_length()
                pad_reqs = [r for _, r in grp] + [grp[-1][1]] * (n_pad - n)
                tokens, positions, lens = pad_prompts(
                    prompts + [prompts[-1]] * (n_pad - n),
                    self.prefill_bucket, pad_len=padded)
                tokens = torch.as_tensor(tokens, device=self.device)
                positions = torch.as_tensor(positions, device=self.device)
                if self.encdec:
                    frames = torch.as_tensor(np.stack(
                        [np.asarray(r.frames, np.float32)
                         for r in pad_reqs]), device=self.device)
                    logits, batch_cache = self._prefill(
                        self.params, tokens, positions, frames)
                else:
                    logits, batch_cache = self._prefill(self.params, tokens,
                                                        positions)
                self._count_nonfinite(logits)
                draft_cache = None
                if self.spec:
                    # the draft's slot state must hold exactly the context
                    # the target slot holds
                    _, draft_cache = self._draft_prefill(
                        self.draft_params, tokens, positions)
                first, rkeys = first_tokens(
                    self._first, self.sampler, self._wants_keys, logits,
                    pad_reqs,
                    token_idx=[len(self._resume_of(r)) for r in pad_reqs])
                now = self.clock()
                for g, (slot, req) in enumerate(grp):
                    resume = self._resume_of(req)
                    try:
                        if self.encdec:
                            # the request's dense cross K/V (batch row g)
                            # land in, or share, arena blocks keyed by
                            # its input's bytes
                            self.pool.insert(
                                _slice_request(batch_cache, g), slot,
                                frames=np.asarray(req.frames, np.float32),
                                cross_k=batch_cache["cross"]["k"][:, g],
                                cross_v=batch_cache["cross"]["v"][:, g])
                        elif self.paged:
                            self.pool.insert(
                                _slice_request(batch_cache, g), slot,
                                prompt=prompts[g], plen=len(prompts[g]),
                                padded_len=padded,
                                budget=req.max_new_tokens - len(resume))
                        else:
                            self.pool.insert(_slice_request(batch_cache, g),
                                             slot)
                    except NoBlocksError:
                        failed.append(slot)
                        continue
                    if self.spec:
                        self.draft_pool.insert(
                            _slice_request(draft_cache, g), slot)
                        self._draft_rows[slot] = padded
                    self._resume.pop(req.rid, None)
                    t0 = int(first[g])
                    if req.trace.admit_t is None:   # the FIRST admission
                        req.trace.admit_t = now     # counts for TTFT
                    req.trace.mark_token(now)
                    self._emitted[slot] = list(resume) + [t0]
                    self._tokens[slot, 0] = t0
                    self._positions[slot, 0] = int(lens[g])
                    self._admit_counter += 1
                    self._admit_seq[slot] = self._admit_counter
                    self._admit_time[slot] = now
                    if rkeys is not None:
                        self._req_keys[slot] = rkeys[g]
                    if len(self._emitted[slot]) >= req.max_new_tokens:
                        self._finish(slot)
            for slot in reversed(failed):
                self.scheduler.requeue(slot)
            if failed:
                return

    def _fits_chunked(self, req: Request) -> bool:
        """Admission gate of a chunked prefill. Its blocks are taken
        only at the insert, many steps after this decision, while every
        decoding slot keeps growing: so on top of the pool's watermark
        the gate holds back one block per decoding slot. Plans with
        share=False, as the insert does. A stale True corrupts nothing:
        the insert's NoBlocksError requeues the request."""
        budget = req.max_new_tokens - len(self._resume_of(req))
        slot = self.scheduler.next_free
        need = self.pool.admission_plan(self._full_prompt(req),
                                        self._plen(req),
                                        self._padded_len(req), budget,
                                        share=False, slot=slot)
        hold = len(self._same_share(slot, self._decode_slots()))
        avail = self.pool.admissible_blocks(slot)
        return all(n + hold <= avail[si] for si, n in need.items())

    def _next_task_fits(self) -> bool:
        """Chunked mode, nothing active or prefilling: does the policy's
        next pick fit the (then empty) arena? A task that finalized and
        finished at admission in this step leaves the engine so, and the
        next step starts the next task. (The JAX engine raises "cannot
        fit an empty paged arena" there: ROADMAP.md, Queue 3.)"""
        if self._admission is None:
            return False
        i = self.sched_policy.pick(self.scheduler.queue_items(),
                                   self._policy_ctx(warm_cache={}))
        return self._fits_chunked(self.scheduler.peek(i))

    def _admit_chunked(self):
        """Start at most one prefill task (policy-picked, block-gated),
        advance it by one budget-sized chunk, and on its last chunk
        insert its cache and emit the first token, with _admit's
        bookkeeping. The slot joins the decode batch in the same step."""
        ctrl = self._admission
        if ctrl.task is None and self.scheduler.free_slots \
                and self.scheduler.queued:
            i = self.sched_policy.pick(self.scheduler.queue_items(),
                                       self._policy_ctx(warm_cache={}))
            req = self.scheduler.peek(i)
            if self._fits_chunked(req):
                slot, req = self.scheduler.assign_at(i)
                prompt = self._full_prompt(req)
                padded = self._padded_len(req)
                tokens, positions, _ = pad_prompts(
                    [prompt], self.prefill_bucket, pad_len=padded)
                ctrl.start(req, slot, tokens, positions,
                           plen=len(prompt), padded_len=padded,
                           resume_len=len(self._resume_of(req)),
                           prompt=prompt)
        task = ctrl.task
        if task is None:
            return
        ctrl.advance(len(self._decode_slots()))
        if not task.finished:
            return
        req, slot = task.req, task.slot
        resume = self._resume_of(req)
        try:
            self.pool.insert(task.cache, slot, prompt=task.prompt,
                             plen=task.plen, padded_len=task.padded_len,
                             budget=req.max_new_tokens - len(resume),
                             share=False)
        except NoBlocksError:
            # decoding slots grew past the gate's dynamic watermark:
            # requeue at the arrival ticket, the continuation state
            # stays parked, and re-admission re-chunks exactly
            self.scheduler.requeue(slot)
            ctrl.drop()
            return
        self._count_nonfinite(task.last_logits)
        first, rkeys = first_tokens(self._first, self.sampler,
                                    self._wants_keys, task.last_logits,
                                    [req], token_idx=[task.resume_len])
        now = self.clock()
        self._resume.pop(req.rid, None)
        t0 = int(first[0])
        if req.trace.admit_t is None:   # the FIRST admission
            req.trace.admit_t = now     # counts for TTFT
        req.trace.mark_token(now)
        self._emitted[slot] = list(resume) + [t0]
        self._tokens[slot, 0] = t0
        self._positions[slot, 0] = task.plen
        self._admit_counter += 1
        self._admit_seq[slot] = self._admit_counter
        self._admit_time[slot] = now
        if rkeys is not None:
            self._req_keys[slot] = rkeys[0]
        ctrl.drop()
        if len(self._emitted[slot]) >= req.max_new_tokens:
            self._finish(slot)

    def _preempt(self, slot: int):
        """Evict a mid-decode victim: blocks freed, generated tokens
        parked as continuation state, request requeued by arrival."""
        req = self.scheduler.active[slot]
        self._resume[req.rid] = self._emitted.pop(slot)
        req.trace.preemptions += 1
        self.preemptions += 1
        self._release(slot)
        self.scheduler.preempt(slot)

    def _grow_active(self):
        """Back every active slot's next writes with blocks (one row, or
        every real verify row of a speculative round), preempting the
        policy's victim when the arena is exhausted. Oldest admissions
        grow first, so the oldest request always progresses."""
        for slot in sorted(self._decode_slots(),
                           key=lambda s: self._admit_seq.get(s, 0)):
            if slot not in self.scheduler.active:
                continue            # preempted as a victim earlier in loop
            row = int(self._positions[slot, 0])
            n_rows = 1
            if self.spec:
                # verify rows past the remaining budget carry position -1
                # and write nothing, so they need no backing
                req = self.scheduler.active[slot]
                n_rows = min(self.spec_k,
                             req.max_new_tokens - len(self._emitted[slot]))
            for r in range(row, row + n_rows):
                if slot not in self.scheduler.active:
                    break           # became the sacrifice below
                while True:
                    try:
                        self.pool.grow(slot, r)
                        break
                    except NoBlocksError:
                        if not self.preempt_enabled:
                            raise RuntimeError(
                                "paged arena exhausted mid-decode with "
                                "preemption disabled: raise slots_budget "
                                "/ watermark, or enable preempt")
                        # only a slot of the same share frees blocks
                        # this slot can take
                        candidates = self._same_share(
                            slot, self._decode_slots())
                        victim = self.sched_policy.victim(
                            candidates, self._policy_ctx())
                        if victim == slot and len(candidates) == 1:
                            raise RuntimeError(
                                "single active slot cannot grow: the arena "
                                "is smaller than one request's chain (raise "
                                "slots_budget)")
                        self._preempt(victim)
                        if victim == slot:
                            break   # this slot was the sacrifice

    def _same_share(self, slot: int, slots: list) -> list:
        """Those of `slots` that the data rank holding `slot` holds (all
        of them off a mesh)."""
        shard = self.layout.shard(slot)
        return [s for s in slots if self.layout.shard(s) == shard]

    def _evict_overdue(self):
        """SLO eviction: an active request older (since admission) than
        the policy's SLO finishes early with the tokens it has."""
        if self.sched_policy.slo_s is None or not self.scheduler.active:
            return
        ctx = self._policy_ctx()
        for slot in self._decode_slots():
            if self.sched_policy.overdue(slot, ctx):
                self.scheduler.active[slot].trace.evicted_slo = True
                self._finish(slot)

    def _step_cache(self):
        if self.paged:
            return {**self.pool.cache, "tables": self.pool.device_tables()}
        return self.pool.cache

    def step(self) -> bool:
        """One iteration: SLO evictions, admissions, lazy growth, then
        one decode step (or speculative round) over the active slots
        (bert engines: admit, one batched forward, complete). False when
        idle."""
        if self.bert:
            return self._step_scoring()
        self._evict_overdue()
        if self._admission is not None:
            self._admit_chunked()
        else:
            self._admit()
        if self.paged and self.pool.growth == "lazy":
            self._grow_active()
            self.pool.flush_growth()
        active = self._decode_slots()
        self.max_concurrent = max(self.max_concurrent, len(active))
        self._depth.sample(self.scheduler.queued)
        if not active:
            prefilling = (self._admission is not None
                          and self._admission.task is not None)
            if self.scheduler.queued and not prefilling \
                    and not self._next_task_fits():
                req = self.scheduler.peek()
                raise RuntimeError(
                    f"request rid={req.rid} (prompt {len(req.prompt)}, "
                    f"budget {req.max_new_tokens}) cannot fit an empty "
                    f"paged arena: raise slots_budget or max_len")
            return self.scheduler.has_work
        if self.spec:
            self._spec_round(active)
        else:
            args = (self.params,
                    torch.as_tensor(self._tokens, device=self.device),
                    torch.as_tensor(self._positions, device=self.device),
                    self._step_cache())
            if self._wants_keys:
                tvec = np.zeros(self.max_batch, np.int32)
                for slot in active:
                    tvec[slot] = len(self._emitted[slot])
                args += (fold_keys(self._req_keys, tvec),)
            nxt, new_cache = self._step(*args)
            self.pool.cache["index"] = new_cache["index"]
            nxt = nxt.cpu().numpy()      # host sync: tokens feed next step
            now = self.clock()
            self.steps_run += 1
            self.slot_steps += len(active)
            for slot in active:
                req = self.scheduler.active[slot]
                self._emitted[slot].append(int(nxt[slot]))
                req.trace.mark_token(now)
                self._tokens[slot, 0] = int(nxt[slot])
                self._positions[slot, 0] += 1
                if len(self._emitted[slot]) >= req.max_new_tokens:
                    self._finish(slot)
        if self.on_step is not None:
            info = {"step": self.steps_run, "active": len(active),
                    "queued": self.scheduler.queued,
                    "preemptions": self.preemptions}
            if self.spec:
                info.update(spec_rounds=self.spec_rounds,
                            drafted_tokens=self.drafted_tokens,
                            accepted_tokens=self.accepted_tokens)
            self.on_step(info)
        return self.scheduler.has_work

    def _step_scoring(self) -> bool:
        """One scoring/embedding iteration: admit up to max_batch queued
        requests in policy order, run ONE batched forward at (max_batch,
        score_len), the short batch padded by replicating its last row
        (outputs discarded), and complete every admitted request: no
        cache holds a slot past its step."""
        sched = self.scheduler
        self._depth.sample(sched.queued)
        pairs = []
        while sched.free_slots and sched.queued:
            i = self.sched_policy.pick(sched.queue_items(),
                                       self._policy_ctx(warm_cache={}))
            pairs.append(sched.assign_at(i))
        if not pairs:
            return sched.has_work
        prompts = [np.asarray(r.prompt, np.int32) for _, r in pairs]
        n = len(pairs)
        tokens, positions, lens = pad_prompts(
            prompts + [prompts[-1]] * (self.max_batch - n), 1,
            pad_len=self.score_len)
        ids, pooled = self._score(
            self.params, torch.as_tensor(tokens, device=self.device),
            torch.as_tensor(positions, device=self.device))
        ids, pooled = ids.cpu().numpy(), pooled.cpu().numpy()
        now = self.clock()
        self.steps_run += 1
        self.slot_steps += n
        self.max_concurrent = max(self.max_concurrent, n)
        for g, (slot, req) in enumerate(pairs):
            req.trace.admit_t = now
            self._admit_counter += 1
            self._fill_scores(req, ids[g], pooled[g], int(lens[g]), now)
            sched.complete(slot)
        return sched.has_work

    def _fill_scores(self, req: Request, ids, pooled, plen: int, now):
        """A scored row's outputs onto its request: the embedding, and
        for task "score" the masked-LM ids of the valid (right-aligned)
        tail, one token mark each."""
        req.embedding = pooled.copy()
        if self.task == "score":
            req.generated = ids[self.score_len - plen:].copy()
            for _ in range(plen):
                req.trace.mark_token(now)
        else:
            req.generated = np.zeros(0, np.int32)
            req.trace.mark_token(now)
        req.trace.done_t = now

    def _spec_round(self, active):
        """One draft-verify round over the active slots.

        Per slot with remaining budget rem and cursor position p:
          1. K draft micro-steps (S=1, the draft's dense pool) propose
             d_1..d_K with keys fold(rkey, emitted + i), the target's.
          2. One verify step feeds [t0, d_1..d_{K-1}] at positions
             p..p+fl-1 (fl = min(K, rem); padding rows carry -1) and
             emits y_1..y_K.
          3. The leading agreement run a emits y_1..y_n, n = min(a+1, fl).
          4. If any slot emitted fewer than K, both pools roll back:
             cursors rewind to q + n and the stale rows' positions drop
             to -1. A full-acceptance round skips the rollback."""
        K = self.spec_k
        B = self.max_batch
        dev = self.device
        tvec = np.zeros(B, np.int32)
        feed_len = np.zeros(B, np.int32)
        for slot in active:
            req = self.scheduler.active[slot]
            tvec[slot] = len(self._emitted[slot])
            feed_len[slot] = min(K, req.max_new_tokens
                                 - len(self._emitted[slot]))

        # ---- 1. draft micro-steps ----------------------------------
        fed = np.zeros((B, K), np.int32)       # d_0..d_{K-1} (d_0 = t0)
        props = np.zeros((B, K), np.int32)     # d_1..d_K
        tok = self._tokens.copy()
        pos = self._positions.copy()
        live = pos[:, 0] >= 0
        for i in range(K):
            fed[:, i] = tok[:, 0]
            args = (self.draft_params, torch.as_tensor(tok, device=dev),
                    torch.as_tensor(pos, device=dev), self.draft_pool.cache)
            if self._wants_keys:
                args += (fold_keys(self._req_keys, tvec + i),)
            nxt, dcache = self._draft_step(*args)
            self.draft_pool.cache["index"] = dcache["index"]
            nxt = nxt.cpu().numpy()
            props[:, i] = nxt
            tok[:, 0] = np.where(live, nxt, 0)
            pos[:, 0] = np.where(live, pos[:, 0] + 1, -1)

        # ---- 2. target verify --------------------------------------
        vpos = np.full((B, K), -1, np.int32)
        for slot in active:
            fl = int(feed_len[slot])
            vpos[slot, :fl] = (int(self._positions[slot, 0])
                               + np.arange(fl, dtype=np.int32))
        args = (self.params, torch.as_tensor(fed, device=dev),
                torch.as_tensor(vpos, device=dev), self._step_cache())
        if self._wants_keys:
            ti = tvec[:, None] + np.arange(K, dtype=np.int32)[None, :]
            flat = fold_keys(np.repeat(self._req_keys, K, axis=0),
                             ti.reshape(-1))
            args += (flat.reshape(B, K, 2),)
        ys, new_cache = self._verify(*args)
        self.pool.cache["index"] = new_cache["index"]
        ys = ys.cpu().numpy()
        now = self.clock()
        self.steps_run += 1
        self.slot_steps += len(active)
        self.spec_rounds += 1

        # ---- 3. acceptance -----------------------------------------
        emits = {}
        for slot in active:
            fl = int(feed_len[slot])
            prop = props[slot, :fl]            # d_1..d_fl
            tgt = ys[slot, :fl]                # y_1..y_fl
            neq = np.nonzero(prop != tgt)[0]
            a = int(neq[0]) if len(neq) else fl
            n_emit = min(a + 1, fl)
            emits[slot] = (n_emit, tgt[:n_emit])
            self.drafted_tokens += fl
            self.accepted_tokens += min(a, n_emit)

        # ---- 4. rollback (reject or budget-truncated rounds) -------
        if any(ne != K for ne, _ in emits.values()):
            stale_t, stale_d = {}, {}
            new_ti = np.zeros(B, np.int32)
            new_di = np.zeros(B, np.int32)
            for slot in active:
                ne = emits[slot][0]
                q = int(self._positions[slot, 0])
                c = int(self._draft_rows[slot])
                stale_t[slot] = range(q + ne, q + K)
                stale_d[slot] = range(c + ne, c + K)
                new_ti[slot] = q + ne
                new_di[slot] = c + ne
            self.pool.rollback_rows(stale_t, new_ti, B * K)
            self.draft_pool.rollback_rows(stale_d, new_di, B * K)

        # ---- bookkeeping (mirrors the non-spec step) ---------------
        for slot in active:
            ne, toks = emits[slot]
            req = self.scheduler.active[slot]
            self._emitted[slot].extend(int(t) for t in toks)
            for _ in range(ne):
                req.trace.mark_token(now)
            self._tokens[slot, 0] = int(toks[-1])
            self._positions[slot, 0] += ne
            self._draft_rows[slot] += ne
            if len(self._emitted[slot]) >= req.max_new_tokens:
                self._finish(slot)

    def run(self, requests: Optional[List[Request]] = None) -> List[Request]:
        """Submit `requests` (if given) and step until idle."""
        for r in requests or ():
            self.submit(r)
        while self.step():
            pass
        return self.scheduler.completed

    def run_batch(self, requests: List[Request]) -> List[Request]:
        """ServeEngine-compatible alias for run(): submit and drain,
        return the same request objects."""
        self.run(requests)
        return requests

    # ---------------- batch-1 latency mode ----------------

    def run_one(self, request: Request) -> Request:
        """Serve ONE request end to end at batch 1, outside the
        scheduler, the admission and the pool: the interactive latency
        path. Its output is the pooled engine's for the same request:
        the same prefill and decode step (and non-finite count), left-pad
        masking and sampler keys, and for encdec the same cross
        contraction length (the dense cross K/V padded to the arena's
        blocked frame count, pads masked as the arena's filler). On a
        mesh every rank serves it, at batch 1: whole on every data rank
        (one slot does not divide over "data"), each model rank on its
        cut, as the pooled engine's steps compute."""
        self._assign_rid(request)
        if request.trace.submit_t == 0.0:
            request.trace.mark_submit()
        if self.bert:
            return self._run_one_scoring(request)
        if self.encdec and request.frames is None:
            raise ValueError(
                "encdec requests need `frames` (the encoder input)")
        if len(request.prompt) + request.max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt {len(request.prompt)} + max_new_tokens "
                f"{request.max_new_tokens} exceeds max_len {self.max_len}")
        return self._run_one_decode(request)

    def _one(self):
        """(decode step, scoring step) of run_one: the pooled engine's
        off a mesh; on one, the same steps for a layout of one slot
        (whole on every data rank, each model rank its cut), built at
        the first call."""
        if self.mesh is None:
            return self._step, self._score
        if self._one_steps is None:
            lay = shd.serve_layout(self.arch.heads, 1, self.mesh,
                                   self.arch.mamba)
            self._one_steps = (
                (None, _score_step(self.arch, self.mesh, lay)) if self.bert
                else (build_serve_step(
                    self.arch.decode_step, self.mesh, sampler=self.sampler,
                    layout=lay, nonfinite=self._nonfinite,
                    vocab=self._vocab), None))
        return self._one_steps

    def _pad_cross(self, cache):
        """Pad a batch-1 dense cross K/V to the arena's blocked frame
        count, pad rows at position -1: the decode contraction then has
        the length of the pooled engine's block gather."""
        ck, cv = cache["cross"]["k"], cache["cross"]["v"]
        sm, pf = ck.shape[2], self.pool.padded_frames
        if pf == sm:
            return cache
        pos = torch.full((pf,), -1, dtype=torch.int32, device=ck.device)
        pos[:sm] = torch.arange(sm, dtype=torch.int32, device=ck.device)
        pad = (0, 0, 0, 0, 0, pf - sm)
        return {**cache, "cross": {
            "k": torch.nn.functional.pad(ck, pad),
            "v": torch.nn.functional.pad(cv, pad), "pos": pos}}

    def _run_one_decode(self, request: Request) -> Request:
        prompt = np.asarray(request.prompt, np.int32)
        tokens, positions, lens = pad_prompts([prompt], self.prefill_bucket)
        if tokens.shape[1] + request.max_new_tokens - 1 > self._prefill_len:
            raise ValueError(
                f"padded prompt {tokens.shape[1]} + budget "
                f"{request.max_new_tokens} exceeds the prefill cache "
                f"({self._prefill_len} rows)")
        dev = self.device
        tokens = torch.as_tensor(tokens, device=dev)
        positions = torch.as_tensor(positions, device=dev)
        if self.encdec:
            frames = torch.as_tensor(
                np.asarray(request.frames, np.float32)[None], device=dev)
            logits, cache = self._prefill(self.params, tokens, positions,
                                          frames)
            cache = self._pad_cross(cache)
        else:
            logits, cache = self._prefill(self.params, tokens, positions)
        self._count_nonfinite(logits)
        first, rkeys = first_tokens(self._first, self.sampler,
                                    self._wants_keys, logits, [request])
        now = self.clock()
        request.trace.admit_t = now
        request.trace.mark_token(now)
        emitted = [int(first[0])]
        tok = np.array([[emitted[0]]], np.int32)
        pos = np.array([[int(lens[0])]], np.int32)
        step, _ = self._one()
        while len(emitted) < request.max_new_tokens:
            args = (self.params, torch.as_tensor(tok, device=dev),
                    torch.as_tensor(pos, device=dev), cache)
            if self._wants_keys:
                args += (fold_keys(rkeys, np.array([len(emitted)],
                                                   np.int32)),)
            nxt, cache = step(*args)
            t = int(nxt.cpu().numpy()[0])
            request.trace.mark_token(self.clock())
            emitted.append(t)
            tok[0, 0] = t
            pos[0, 0] += 1
        request.generated = np.array(emitted, np.int32)
        request.trace.done_t = request.trace.token_ts[-1]
        return request

    def _run_one_scoring(self, request: Request) -> Request:
        prompt = np.asarray(request.prompt, np.int32)
        if not 1 <= len(prompt) <= self.score_len:
            raise ValueError(
                f"scoring prompt length {len(prompt)} must be in "
                f"[1, {self.score_len}]")
        tokens, positions, lens = pad_prompts([prompt], 1,
                                              pad_len=self.score_len)
        _, score = self._one()
        ids, pooled = score(
            self.params, torch.as_tensor(tokens, device=self.device),
            torch.as_tensor(positions, device=self.device))
        now = self.clock()
        request.trace.admit_t = now
        self._fill_scores(request, ids.cpu().numpy()[0],
                          pooled.cpu().numpy()[0], int(lens[0]), now)
        return request

    def report(self, wall_s: float) -> dict:
        """Throughput/latency stats of the completed requests plus slot
        utilization, decode steps (scoring: forwards), peak concurrency,
        queue depth, preemptions, the task, the number of steps whose
        logits were not all finite, (paged, encdec) prefix or cross
        block hits, (chunked) chunk forwards, rows and forwards per chunk
        size, and (speculative) rounds and acceptance; mesh_devices, the
        ranks of the mesh (1 off a mesh)."""
        done = self.scheduler.completed
        stats = aggregate([r.trace for r in done], wall_s,
                          sum(len(r.generated) for r in done))
        denom = max(1, self.steps_run * self.max_batch)
        stats["slot_utilization"] = self.slot_steps / denom
        stats["decode_steps"] = self.steps_run
        stats["max_concurrent"] = self.max_concurrent
        stats["preemptions"] = self.preemptions
        stats["sched_policy"] = self.sched_policy.name
        stats["mesh_devices"] = (self.mesh.size() if self.mesh is not None
                                 else 1)
        stats.update(self._depth.stats())
        stats["task"] = self.task
        if self.paged or self.encdec:
            if self.paged:
                stats["growth"] = self.pool.growth
            stats["shared_block_hits"] = self.pool.shared_hits
            stats["retained_block_hits"] = self.pool.retained_hits
            stats["prefix_misses"] = self.pool.prefix_misses
            stats["retained_hit_rate"] = self.pool.retained_hit_rate
        if self._admission is not None:
            stats["chunk_budget"] = self.chunk_budget
            stats["chunk_steps"] = self._admission.chunks_run
            stats["chunk_tokens"] = self._admission.chunk_tokens
            stats["chunk_sizes"] = dict(sorted(
                self._admission.size_counts.items()))
        if self.spec:
            stats["spec_k"] = self.spec_k
            stats["spec_rounds"] = self.spec_rounds
            stats["drafted_tokens"] = self.drafted_tokens
            stats["accepted_tokens"] = self.accepted_tokens
            stats["acceptance_rate"] = (self.accepted_tokens
                                        / max(1, self.drafted_tokens))
        stats["nonfinite_logit_steps"] = int(self._nonfinite)
        return stats


class ServeEngine:
    """Static-batch baseline: one padded prefill, lockstep decode. Shares
    the decode step, precision policy, sampler keys and left-pad masking
    with ContinuousEngine."""

    def __init__(self, arch, params, *, max_len: int = 512, policy=None,
                 mesh=None, sampler=None):
        # mesh is taken for signature parity with ContinuousEngine and
        # never used: the static baseline is the one-device reference a
        # sharded engine is held to, as in the JAX package
        del mesh
        if arch.kind != "decoder":
            raise ValueError(f"serving needs a decoder arch, got {arch.kind}")
        self.arch, self.params = apply_serving_policy(arch, params, policy)
        self.device = self.params["embed"]["embedding"].device
        self.max_len = max_len
        self.granularity = prompt_granularity(self.arch.cfg)
        self.sampler = Sampler.parse(sampler)
        self._step = build_serve_step(self.arch.decode_step,
                                      sampler=self.sampler)
        self._prefill = build_prefill_fn(self.arch, max_len)
        self._first, self._wants_keys = build_first_token_fn(self.sampler)
        self._next_rid = 0

    def run_batch(self, requests: List[Request]) -> List[Request]:
        """Serve one padded batch to completion: a single left-padded
        prefill, then lockstep decode for max(max_new_tokens) steps.
        Fills each request's `generated`/trace in place and returns the
        same list."""
        assert requests
        steps = max(r.max_new_tokens for r in requests)
        tokens, positions, lens = pad_prompts(
            [r.prompt for r in requests], self.granularity)
        if tokens.shape[1] + steps > self.max_len:
            raise ValueError(
                f"padded prompt {tokens.shape[1]} + {steps} new tokens "
                f"exceeds max_len {self.max_len}")
        for r in requests:
            # keep an earlier submission stamp: callers running waves
            # stamp the whole workload up front, so TTFT includes the
            # wait behind earlier waves
            if r.trace.submit_t == 0.0:
                r.trace.mark_submit()
            if r.rid is None:
                r.rid = self._next_rid
                self._next_rid += 1
        dev = self.device
        logits, cache = self._prefill(
            self.params, torch.as_tensor(tokens, device=dev),
            torch.as_tensor(positions, device=dev))
        tok, rkeys = first_tokens(self._first, self.sampler,
                                  self._wants_keys, logits, requests)
        out = [tok]
        now = time.perf_counter()
        for r in requests:
            r.trace.admit_t = now
            r.trace.mark_token(now)
        pos_next = lens.copy()
        for i in range(steps - 1):
            args = (self.params, torch.as_tensor(tok[:, None], device=dev),
                    torch.as_tensor(pos_next[:, None], device=dev), cache)
            if self._wants_keys:
                args += (fold_keys(rkeys, np.full(len(requests), i + 1)),)
            nxt, cache = self._step(*args)
            tok = nxt.cpu().numpy()
            now = time.perf_counter()
            out.append(tok)
            pos_next += 1
            for r in requests:
                if len(r.trace.token_ts) < r.max_new_tokens:
                    r.trace.mark_token(now)
        gen = np.stack(out, axis=1)      # (B, steps)
        for i, r in enumerate(requests):
            r.generated = gen[i, :r.max_new_tokens]
            r.trace.done_t = r.trace.token_ts[-1]
        return requests


def throughput_probe(engine, requests: List[Request], *,
                     warmup: bool = True) -> dict:
    """Timed run over `requests`: tokens/s and latency percentiles.
    warmup=True first runs a shape-identical clone of the request set, so
    that first-use costs (cuBLAS's kernel choice for each prefill and
    decode shape, the allocator's segments) stay out of the measured wall
    clock. On CUDA the host syncs on every step's tokens, so the wall
    clock ends with the device's work."""
    if warmup:
        clones = [Request(prompt=r.prompt.copy(),
                          max_new_tokens=r.max_new_tokens, frames=r.frames)
                  for r in requests]
        engine.run_batch(clones)
    t0 = time.perf_counter()
    done = engine.run_batch(requests)
    dt = time.perf_counter() - t0
    toks = sum(len(r.generated) for r in done)
    stats = aggregate([r.trace for r in done], dt, toks)
    stats["warmup"] = warmup
    return stats
