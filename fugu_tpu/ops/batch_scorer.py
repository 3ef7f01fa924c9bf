"""Two-phase batched query engine: corpus-stream phase A + pruned phase B.

The single-query block scorer visits every nonempty block per query, but
the TRUE top-k docs of a query live in ~k blocks.  Sum-of-max WAND
bounds cannot find them (the corpus is too homogeneous); exact per-block
maxima can.  So:

**Phase A** (a Pallas kernel through Triton): ONE pass over the
segment's block-major pack (index/segment.py BlockMajorPack: entries
sorted by doc) computes, for the whole query batch at once, the max
score per (fine doc slice, query).  One program owns one 64-doc
sub-block and one tile of query lanes; per 64-entry step it gathers
each entry's weight row by union slot and scatters into its docs with a
one-hot product on the tensor cores:

    V[e, q]  = W[slot(tid[e]), q] * contrib[e]          (bf16)
    S[d, q] += onehot_doc[d, e] @ V[e, q]               (f32 sums)

where W is the per-(union term, query) BM25 weight matrix and contrib
is the precomputed weight-free tf/(tf + norm) component.  The work is
shared by all B queries — the batch visits each posting once instead of
once per query that contains its term — and the [entries x lanes]
intermediate never leaves registers.

**Phase B**: per query, only blocks whose phase-A max can still reach
the kth score (with a bf16-error margin) are re-scored exactly by the
block scorer (ops/pallas_scorer with per-query block lists).

- **Pure-SHOULD plans** (one phase-B wave): the kth-of-maxima is a valid
  lower bound because block maxima are real doc scores (blocks partition
  docs; dead docs are zeroed out of the pack).
- **Boolean plans** (MUST / MUST_NOT / facet filters): phase A carries a
  second set of lanes that counts, per doc, the distinct single-clause
  MUST terms present (MUST_NOT terms count -64), and the maxima are
  masked to docs passing ``count == n_must`` — the unconstrained sum
  bound is uselessly loose for selective intersections.  When the mask
  reproduces the match set exactly ("exact"/"shift" kinds — every MUST
  single-clause; require-should either implied by ``scores > 0`` or
  restored by excluding the constant facet score from W and adding it
  back on the host), the masked maxima are achievable scores and one
  wave suffices.  Otherwise ("upper" kind) wave 1 scores the
  best-bounded blocks to establish the kth score and wave 2 sweeps the
  remaining candidates.  Under-filled wave-1 results degrade to a full
  candidate sweep (thresh = -inf), never to a wrong answer.

Eligibility: term/facet plans at default k1/b with no phrases, ranges,
or nested subplans.  Parity: phase B is the oracle-checked block scorer
and waves partition doc space, so merged results are identical to the
single-phase engine.
"""

from __future__ import annotations

import functools
import os
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from fugu_tpu import jax_setup
from fugu_tpu.index.segment import (
    BM_BLOCK_DOCS,
    BM_SUB_DOCS,
    BM_SUBS_PER_BLOCK,
    FACET_FIELD_KEY,
    Segment,
)
from fugu_tpu.ops.scoring import NEG_INF
from fugu_tpu.query import Occur, QueryPlan, bm25_weight, idf

jax_setup.configure()

B_PAD = 256          # max queries per phase-A dispatch
B_BUCKETS = (64, 128, 256)  # query-lane ladder (work scales with b_pad)
#: union-term ladder (rows of W); beyond the last -> greedy split
U_BUCKETS = (256, 384, 512, 768, 1024)
#: relative + absolute margin absorbing bf16 error in the maxima vs the
#: exact f32 score: three bf16 roundings max — w stored bf16, con stored
#: bf16 (BlockMajorPack), and the v=(w*con) product's bf16 cast — so
#: correctness needs m >= 3*eps_bf16 ~= 0.0118.  The kernel's other
#: operand is an exact 0/1 one-hot and its sums are f32 (no TF32 input
#: rounding: both dot operands are bf16), so nothing else enters the
#: margin.  Looser margins balloon phase-B candidate lists.
MARGIN_REL = 0.015
MARGIN_ABS = 3e-3
#: phase A pays one full corpus stream per dispatch; below this many
#: eligible queries the single-phase engine is cheaper (fitted on
#: earlier hardware; not re-measured on the H100)
MIN_BATCH = 24

#: score-lane gating constants ("neg"/"gate" kinds — boolean constraints
#: WITHOUT the lane-doubling count matmul):
#: - a MUST facet clause contributes its weight EXACTLY (facet entries
#:   carry contribution 1.0), so weighting it GATE_BIG makes "all n
#:   facet MUSTs present" detectable as scores > (n-0.5)*GATE_BIG; the
#:   real idf moves to the host-side shift.  2^14 keeps f32 accumulation
#:   granularity at <= 2^-7 for n <= 4 gates (GATE_MARGIN absorbs it)
#:   while any realistic BM25 score stays far below GATE_BIG/2.
#: - a MUST_NOT clause weighted W_MUSTNOT drives any matching doc's
#:   score hard negative (below every gate/zero threshold): the minimum
#:   entry contribution is tf/(tf+cache) >= ~2^-13 (tf=1, 5000-token
#:   field), so the penalty is >= 2^26 * 2^-13 = 2^13 = GATE_BIG/2,
#:   which clears the worst case (a doc missing half a gate step).
GATE_BIG = 2.0 ** 14
W_MUSTNOT = -(2.0 ** 26)
#: extra absolute margin for gate-kind thresholds: f32 rounding of
#: score + n*GATE_BIG quantizes the score part by up to ~2^-5
GATE_MARGIN = 0.0625

#: kinds served by the narrow (no count lanes) kernel
NARROW_KINDS = ("pure", "neg", "gate")

#: count-lane bit-packing: two queries' counts share one f32 lane as
#: ``lo + hi * _PACK_FIELD``.  Counts are small exact integers (must +1,
#: MUST_NOT -64; |value| <= 1024 per field), so the packed sum stays
#: integer-exact in f32 (< 2^23) and the two fields separate by
#: round-divide.  W's lanes drop from 2B to 1.5B; only b_pad=256
#: batches pack.
_PACK_FIELD = 4096.0
_PACK_MIN_B = 256


#: fixed cost of one extra corpus stream, in equivalent query lanes: a
#: split must save more lanes than this to win (fitted on earlier
#: hardware; not re-measured on the H100)
_STREAM_PENALTY_LANES = 96

#: phase-A maxima granularity: FINE_PER_BLOCK maxima per 512-doc block
#: (256-doc halves at the default 2).  Finer maxima are nearly free in
#: the kernel (it already produces per-sub-block maxima) and strictly
#: tighten phase B: the kth-of-maxima over a SUPERSET of finer values is
#: >= the coarse kth, and cold halves of hot blocks drop out of the
#: candidate mask; they cost postproc top_k rows and mask traffic.
#: FUGU_FINE_PER_BLOCK in {1,2,4,8} pins it.
FINE_PER_BLOCK = int(os.environ.get("FUGU_FINE_PER_BLOCK", "2"))
if FINE_PER_BLOCK not in (1, 2, 4, 8):
    raise ValueError(f"FUGU_FINE_PER_BLOCK={FINE_PER_BLOCK} not in (1,2,4,8)")
BM_FINE_DOCS = BM_BLOCK_DOCS // FINE_PER_BLOCK

#: granularity is a PER-STREAM planner decision unless the env var pins
#: it globally: a stream whose every live query extracts deep
#: (limit > DEEP_LIMIT, the k-extract ladder's mid rung) takes fine=4,
#: while mixed/shallow streams keep the default (the finer rows pay off
#: only when the kth threshold needs the tighter maxima).
_FINE_PINNED = "FUGU_FINE_PER_BLOCK" in os.environ
DEEP_LIMIT = 32
DEEP_FINE = 4


def _fine_for_stream(q_idx, limits) -> int:
    """Phase-A maxima granularity for one corpus stream."""
    if _FINE_PINNED:
        return FINE_PER_BLOCK
    live = [limits[i] for i in q_idx if i is not None]
    if live and all(lim > DEEP_LIMIT for lim in live):
        return DEEP_FINE
    return FINE_PER_BLOCK


@functools.lru_cache(maxsize=None)
def _lane_plan(n: int) -> Tuple[int, ...]:
    """Bucket capacities covering ``n`` queries minimizing padded lanes
    plus the fixed per-stream overhead (in equivalent lanes)."""
    if n <= 0:
        return ()
    best = None
    for b in B_BUCKETS:
        cand = (b,) if n <= b else (b,) + _lane_plan(n - b)
        key = (sum(cand) + _STREAM_PENALTY_LANES * (len(cand) - 1), len(cand))
        if best is None or key < best[0]:
            best = (key, cand)
    return best[1]


#: entries per inner step and query lanes per program of the phase-A
#: kernel: one program owns one BM_SUB_DOCS-doc sub-block x one lane tile
#: and keeps its [BM_SUB_DOCS, lane tile] f32 accumulators in registers
_ENTRY_TILE = 64
_LANE_TILE = 128


def _count_lanes(b_pad: int, wide: bool, packed: bool) -> int:
    """Width of the count half of W: 0 (narrow), b_pad (wide) or
    b_pad // 2 (two bit-packed queries per lane)."""
    if packed:
        return b_pad // 2
    return b_pad if wide else 0


def _slot_table(tids, n_terms_pad: int):
    """Global term id -> union slot (-1 = not in this batch's union)."""
    u_pad = tids.shape[0]
    idx = jnp.where(tids >= 0, tids, n_terms_pad)  # empty slots: dropped
    return (
        jnp.full((n_terms_pad,), -1, jnp.int32)
        .at[idx]
        .set(jnp.arange(u_pad, dtype=jnp.int32), mode="drop")
    )


def _unpack_counts(cnt, q, b_pad: int, count_lanes: int):
    """Per-query must-counts from the count lanes.  Packed lanes hold
    ``lo + hi * _PACK_FIELD`` (query q < b_pad//2 in lo, the rest in hi);
    both fields are exact small integers (|lo| <= 1024), so the rounded
    quotient separates them."""
    if count_lanes == b_pad:
        return cnt
    hi = jnp.floor(cnt * (1.0 / _PACK_FIELD) + 0.5)
    lo = cnt - hi * _PACK_FIELD
    return jnp.where(q < count_lanes, lo, hi)


def _phasea_kernel(
    offs_ref,   # int32[NSUB+1] first entry of each doc sub-block
    doc_ref,    # int32[E]      doc-sorted doc ids (-1 = padding)
    tid_ref,    # int32[E]      global term ids
    con_ref,    # bf16[E]       weight-free contributions
    slot_ref,   # int32[NT]     global term id -> union slot (-1 = absent)
    w_ref,      # bf16[U, B + count lanes] [weights | must-counts]
    nm_ref,     # f32[B]        per-query threshold / required count
    out_ref,    # f32[NSUB, B]  per-(sub-block, query) maxima
    *,
    b_pad: int,
    count_lanes: int,
    lane_tile: int,
):
    s = pl.program_id(0)
    q = pl.program_id(1) * lane_tile + jnp.arange(lane_tile)
    e0 = plgpu.load(offs_ref.at[s])
    e1 = plgpu.load(offs_ref.at[s + 1])
    base = s * BM_SUB_DOCS
    d_iota = jnp.arange(BM_SUB_DOCS)
    if count_lanes:
        cq = b_pad + q % count_lanes

    def step(i, accs):
        e = e0 + i * _ENTRY_TILE + jnp.arange(_ENTRY_TILE)
        live = e < e1
        doc = plgpu.load(doc_ref.at[e], mask=live, other=-1)
        tid = plgpu.load(tid_ref.at[e], mask=live, other=-1)
        con = plgpu.load(con_ref.at[e], mask=live, other=0).astype(
            jnp.float32
        )
        slot = plgpu.load(
            slot_ref.at[jnp.maximum(tid, 0)], mask=tid >= 0, other=-1
        )
        hit = (slot >= 0)[:, None]
        row = jnp.maximum(slot, 0)[:, None]
        # the doc scatter is a one-hot product on the tensor cores:
        # bf16 operands (0/1 and the bf16-rounded w*con), f32 sums
        oh = ((doc - base)[None, :] == d_iota[:, None]).astype(jnp.bfloat16)
        w = plgpu.load(w_ref.at[row, q[None, :]], mask=hit, other=0)
        v = (w.astype(jnp.float32) * con[:, None]).astype(jnp.bfloat16)
        out = (accs[0] + pl.dot(oh, v),)
        if count_lanes:
            # count weights are small integers: exact in bf16
            wc = plgpu.load(w_ref.at[row, cq[None, :]], mask=hit, other=0)
            out += (accs[1] + pl.dot(oh, wc.astype(jnp.bfloat16)),)
        return out

    zeros = jnp.zeros((BM_SUB_DOCS, lane_tile), jnp.float32)
    init = (zeros, zeros) if count_lanes else (zeros,)
    n_steps = (e1 - e0 + _ENTRY_TILE - 1) // _ENTRY_TILE
    accs = jax.lax.fori_loop(0, n_steps, step, init)
    nm = plgpu.load(nm_ref.at[q])
    scores = accs[0]
    if count_lanes:
        counts = _unpack_counts(accs[1], q[None, :], b_pad, count_lanes)
        # docs containing every single-clause MUST term and no MUST_NOT
        # term (those count -64); counts are exact integers
        ok = (scores > 0.0) & (counts > nm[None, :] - 0.5)
    else:
        # nm is a score threshold: 0 for pure plans, (n - 0.5) * GATE_BIG
        # for gate plans; unmatched and dead docs score exactly 0
        ok = scores > nm[None, :]
    best = jnp.where(ok, scores, NEG_INF).max(axis=0)
    plgpu.store(out_ref.at[s, pl.ds(pl.program_id(1) * lane_tile, lane_tile)], best)


def _phasea_triton(offs, doc, tid, con, w, tids, nm, *, nb_pad, b_pad,
                   count_lanes, fine, n_terms_pad, interpret):
    lane_tile = min(_LANE_TILE, b_pad)
    n_sub = nb_pad * BM_SUBS_PER_BLOCK
    kernel = functools.partial(
        _phasea_kernel, b_pad=b_pad, count_lanes=count_lanes,
        lane_tile=lane_tile,
    )
    sub_max = pl.pallas_call(
        kernel,
        grid=(n_sub, b_pad // lane_tile),
        out_shape=jax.ShapeDtypeStruct((n_sub, b_pad), jnp.float32),
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=2),
        backend="triton",
        interpret=interpret,
        name="fugu_phasea",
    )(offs, doc, tid, con, _slot_table(tids, n_terms_pad), w, nm)
    return sub_max.reshape(
        nb_pad, fine, BM_SUBS_PER_BLOCK // fine, b_pad
    ).max(axis=2)


def phasea_callable(
    nb_pad: int,
    b_pad: int,
    wide: bool,
    packed: bool = False,
    fine: Optional[int] = None,
    n_terms_pad: int = 1024,
    interpret: Optional[bool] = None,
):
    """The raw (unjitted) phase-A call
    ``(sub_offs, doc, tid, con, w, tids, nm) -> f32[nb_pad, fine, b_pad]``
    — jitted directly for the single-device engine, wrapped in shard_map
    by parallel/batch_sharded.  ``interpret`` runs the Triton kernel in
    Pallas interpret mode (default: jax_setup.pallas_interpret())."""
    if fine is None:
        fine = FINE_PER_BLOCK
    if interpret is None:
        interpret = jax_setup.pallas_interpret()
    return functools.partial(
        _phasea_triton,
        nb_pad=nb_pad,
        b_pad=b_pad,
        count_lanes=_count_lanes(b_pad, wide, packed),
        fine=fine,
        n_terms_pad=n_terms_pad,
        interpret=interpret,
    )


_PHASEA_CACHE: dict = {}


def _get_phasea(nb_pad, b_pad, wide, packed, fine, n_terms_pad):
    key = (nb_pad, b_pad, wide, packed, fine, n_terms_pad)
    if key not in _PHASEA_CACHE:
        _PHASEA_CACHE[key] = jax.jit(
            phasea_callable(nb_pad, b_pad, wide, packed, fine, n_terms_pad)
        )
    return _PHASEA_CACHE[key]


def pad_sub_offs(sub_offs: np.ndarray, nb_pad: int) -> np.ndarray:
    """Sub-block entry offsets padded to nb_pad blocks (padded
    sub-blocks own no entries)."""
    offs = np.full(nb_pad * BM_SUBS_PER_BLOCK + 1, sub_offs[-1], np.int32)
    offs[: len(sub_offs)] = sub_offs
    return offs


def n_terms_bucket(n_terms: int) -> int:
    """Length of the per-batch term-id -> union-slot table."""
    from fugu_tpu.index.segment import _pow2_bucket

    return _pow2_bucket(max(n_terms, 1))


#: bits of candidate mask packed per int32 word for the compact fetch
_PACK = 16


def _build_postproc(nb_pad: int, b_pad: int, fine: int):
    """Device-side phase-A candidate selection (plain XLA).

    The raw maxima are [nb_pad, fine, b_pad] f32 — ~2-4MB per batch.
    The host only needs, per query, the fine blocks whose maximum clears
    the kth-score threshold, so compute kth-of-maxima and the margin
    threshold on device and ship a 16-bit-packed candidate mask +
    per-query finite counts (~260KB) instead.  Matches the host logic exactly up to f32-vs-f64 threshold
    rounding, which the bf16 margin dwarfs (MARGIN_REL covers the
    3-bf16-rounding worst case — see the constant's comment)."""
    nb2 = nb_pad * fine
    k_top = min(128, nb2)

    def post(amax, shift, limidx, margin):
        col = amax.reshape(nb2, -1)                     # [NB*F, B]
        finite = jnp.isfinite(col)
        col = jnp.where(finite, col + shift[None, :], NEG_INF)
        count = jnp.sum(finite.astype(jnp.int32), axis=0)      # [B]
        top = jax.lax.top_k(col.T, k_top)[0]            # [B, k_top] desc
        li = jnp.maximum(limidx, 0)
        kth = jnp.take_along_axis(top, li[:, None], axis=1)[:, 0]
        # limidx -1 flags limit > k_top (or an inactive pad lane): no
        # valid kth exists, fall through to the full-sweep mask
        have = (limidx >= 0) & (count > li)
        # per-query extra absolute margin (gate-kind f32 quantization)
        thresh = jnp.where(
            have,
            kth - jnp.abs(kth) * MARGIN_REL - MARGIN_ABS - margin,
            NEG_INF,
        )
        # under-filled queries get thresh=-inf and an all-true mask (the
        # host's "full candidate sweep, never a wrong answer" fallback);
        # padded NEG_INF blocks only pass in that degenerate case and the
        # host trims indices >= nb
        mask = col >= thresh[None, :]                   # [NB*F, B]
        w = (1 << jnp.arange(_PACK, dtype=jnp.int32))[None, :, None]
        packed = jnp.sum(
            mask.reshape(nb2 // _PACK, _PACK, b_pad).astype(jnp.int32) * w,
            axis=1,
        )                                               # [NB*F/16, B]
        # counts ride as an extra row: one device buffer
        return jnp.concatenate([packed, count[None, :]], axis=0)

    return jax.jit(post)


_POSTPROC_CACHE: dict = {}


def _get_postproc(nb_pad, b_pad, fine=None):
    if fine is None:
        fine = FINE_PER_BLOCK
    key = (nb_pad, b_pad, fine)
    if key not in _POSTPROC_CACHE:
        _POSTPROC_CACHE[key] = _build_postproc(nb_pad, b_pad, fine)
    return _POSTPROC_CACHE[key]


def _unpack_mask(words_q: np.ndarray, nb: int) -> np.ndarray:
    """Candidate block ids from one query's packed mask column."""
    bits = (words_q[:, None] >> np.arange(_PACK)) & 1
    return np.nonzero(bits.reshape(-1)[:nb])[0]


def _nb_pad(nb: int) -> int:
    for v in (64, 256, 1024, 2048, 4096, 8192):
        if nb <= v:
            return v
    return ((nb + 1023) // 1024) * 1024


#: wave-1 big-blocks scored per constrained query to establish the kth
#: lower bound (4 x 2048 docs is plenty for k <= 128 on non-degenerate
#: corpora; a degenerate wave 1 just means wave 2 sweeps more blocks)
ROUND1_BLOCKS = 4


def _classify(plan: QueryPlan) -> Optional[str]:
    """Phase-A pruning class for one plan.

    - "pure": all-SHOULD — block maxima are achievable doc scores, one
      phase-B wave, narrow kernel.
    - "neg": SHOULDs + MUST_NOTs only — narrow kernel; each MUST_NOT
      term carries W_MUSTNOT in the SCORE lane, so excluded docs go hard
      negative and ``scores > 0`` drops them (no count lanes).
    - "gate": every MUST group is a single FACET clause (+ optional
      SHOULDs/MUST_NOTs) — narrow kernel; each facet MUST contributes
      exactly GATE_BIG (facet contributions are 1.0), eligibility is the
      per-query threshold ``scores > (n-0.5)*GATE_BIG``, and the host
      shift (-n*GATE_BIG + sum(idf)) turns maxima back into real scores.
    - "exact": boolean plan whose count mask reproduces the match set
      exactly (every MUST group single-clause, and the require-should
      constraint either absent or implied by ``scores > 0``) — the masked
      maxima are achievable constrained scores, one wave (wide kernel).
    - "upper": boolean plan where the mask is only an upper bound
      (multi-clause MUST groups are uncountable; require_should with
      both MUST and SHOULD groups is not encoded) — two waves.
    - None: this path does not handle it (phrases/ranges/subplans,
      non-default constants, no positive clause, staging limits).
    """
    from fugu_tpu.query import K1, B as B_CONST

    if plan.host_only or plan.is_empty:
        return None
    if plan.k1 != float(K1) or plan.b != float(B_CONST):
        return None  # contributions precomputed at default constants
    n_clauses = 0
    n_must = n_should = 0
    must_countable = True
    gate_ok = True  # every MUST a single facet clause
    has_scoring = False
    max_boost = 0.0
    for g in plan.groups:
        if g.phrases or g.ranges or g.subplan is not None:
            return None
        n_clauses += len(g.clauses)
        for c in g.clauses:
            max_boost = max(max_boost, abs(c.boost))
        if g.occur is Occur.MUST:
            n_must += 1
            if len(g.clauses) != 1:
                must_countable = False
                gate_ok = False
            elif not g.clauses[0].is_facet:
                gate_ok = False
            if g.clauses:
                has_scoring = True
        elif g.occur is Occur.MUST_NOT:
            pass  # any-clause penalty counts exactly even multi-clause
        elif g.clauses:
            n_should += 1
            has_scoring = True
    if not has_scoring:
        return None  # nothing produces a positive bound
    # every kind re-scores through the block scorer in phase B: respect
    # its staging limits (t_pad <= 16, <= 32 boolean groups) BEFORE
    # classifying, or an over-wide plan burns a phase-A corpus stream
    # (and inflates the batch's u_pad bucket) only to fall back anyway
    if n_clauses > 16 or len(plan.groups) > 32:
        return None
    has_not = any(g.occur is Occur.MUST_NOT for g in plan.groups)
    if n_must == 0 and not has_not:
        return "pure"
    if n_must == 0:
        # MUST_NOTs alone gate through the score lane — but only while
        # no SHOULD can out-score the W_MUSTNOT*con penalty of the
        # excluded term (worst case ~2^26 * 1e-3 ≈ 6.6e4 for a 10k-char
        # doc vs <= 16 clauses * boost * idf * (k1+1) ≈ 740 unboosted).
        # The same boost cap as "gate" keeps an order of magnitude of
        # headroom; larger boosts reroute to the count-lane "exact"
        # staging, whose -64 count penalty is boost-immune.
        return "neg" if max_boost <= 8.0 else "exact"
    if gate_ok and n_must <= 4 and max_boost <= 8.0:
        # gate-soundness bounds: n <= 4 keeps f32 granularity at
        # score+n*GATE_BIG under GATE_MARGIN; bounded boosts keep every
        # real score far below GATE_BIG/2 (an ineligible doc must not
        # out-score half a gate step).  require_should is safe at this
        # threshold: a should-less gated doc reports exactly n*GATE_BIG
        # (facet contributions are exact), which never exceeds any
        # eligible doc's value in any block, so the kth-of-maxima stays
        # a valid lower bound and phase B enforces the true
        # "at least one SHOULD" semantics.
        return "gate"
    if must_countable and not (
        plan.require_should and n_should > 0 and n_must > 0
    ):
        return "exact"
    # require_should + MUSTs: if every MUST is a single facet clause, its
    # score contribution is a per-query CONSTANT (idf; fieldnorm is
    # constant for facets).  Excluding those weights from W makes
    # ``scores > 0`` equivalent to "some SHOULD matched", the count mask
    # enforces facet presence, and the host adds the constant back to the
    # maxima — the bound becomes exact again ("shift" kind).
    if must_countable and all(
        g.clauses[0].is_facet
        for g in plan.groups
        if g.occur is Occur.MUST
    ):
        return "shift"
    return "upper"


def batch_search_should(
    segment: Segment,
    plans: Sequence[QueryPlan],
    stats,
    limit: int,
    min_batch: int = MIN_BATCH,
) -> List[Optional[List[Tuple[float, int]]]]:
    """Single-limit wrapper around :func:`batch_search`."""
    return batch_search(
        segment, plans, stats, [limit] * len(plans), min_batch
    )


def _plan_tids(plan: QueryPlan, tid_of: Dict[tuple, int]) -> set:
    tids = set()
    for g in plan.groups:
        # MUST_NOT terms never score but DO join the union: they
        # carry the -64 count penalty that masks excluded docs
        for c in g.clauses:
            field = FACET_FIELD_KEY if c.is_facet else c.field
            t = tid_of.get((field, c.term))
            if t is not None:
                tids.add(t)
    return tids


def plan_batches(plans, elig, kinds, tid_of):
    """Partition eligible plan indices into phase-A batches.

    Greedy fill splits when the term union exceeds the largest U bucket
    (each batch pays a full corpus stream); lane-fit then re-splits each
    batch over the B_BUCKETS ladder minimizing padded lanes + the
    per-stream penalty (phase-A flops scale with the lane count).
    Returns (batches, batch_terms) with per-batch term->slot maps."""
    batches: List[List[int]] = []
    cur: List[int] = []
    cur_terms: Dict[int, int] = {}
    for i in elig:
        tids = _plan_tids(plans[i], tid_of)
        new = [t for t in tids if t not in cur_terms]
        boundary = cur and (
            (kinds[cur[0]] in NARROW_KINDS) != (kinds[i] in NARROW_KINDS)
        )
        if len(cur) >= B_PAD or boundary or (
            cur and len(cur_terms) + len(new) > U_BUCKETS[-1]
        ):
            batches.append(cur)
            cur, cur_terms = [], {}
            new = list(tids)
        for t in new:
            cur_terms[t] = len(cur_terms)
        cur.append(i)
    if cur:
        batches.append(cur)

    split: List[List[int]] = []
    for q_idx in batches:
        for size in _lane_plan(len(q_idx)):
            split.append(q_idx[:size])
            q_idx = q_idx[size:]
            if not q_idx:
                break
    batch_terms = []
    for q_idx in split:
        terms: Dict[int, int] = {}
        for i in q_idx:
            for t in _plan_tids(plans[i], tid_of):
                if t not in terms:
                    terms[t] = len(terms)
        batch_terms.append(terms)
    return split, batch_terms


def stage_batch_weights(
    plans, kinds, q_idx, terms, stats, tid_of, b_pad, wide, k1, shifts,
    packed=False,
):
    """(w2, nmust, tid_arr) operand staging for one phase-A batch.

    Fills ``shifts`` for "shift"-kind plans (constant MUST-facet scores
    added back to the maxima after the stream) and for "gate"-kind plans
    (sum(idf) - n*GATE_BIG: the gates come OFF and the real facet scores
    go ON).  For narrow batches the nm row carries the per-query score
    threshold ((n-0.5)*GATE_BIG for gate plans, 0 otherwise); for wide
    batches it keeps the required MUST count.

    With ``packed`` the count lanes are bit-packed two queries per lane
    (query qi < b_pad//2 in the low field, qi >= b_pad//2 in the high
    field of lane b_pad + qi % (b_pad//2)); ``q_idx`` may then contain
    None entries (pad lanes keeping pair geometry)."""
    u_pad = next(u for u in U_BUCKETS if len(terms) <= u)
    if packed:
        w_lanes = b_pad + b_pad // 2
    else:
        w_lanes = 2 * b_pad if wide else b_pad
    w2 = np.zeros((u_pad, w_lanes), dtype=np.float32)
    nmust = np.zeros(b_pad, dtype=np.float32)
    tid_arr = np.full(u_pad, -2, dtype=np.int32)
    for t, slot in terms.items():
        tid_arr[slot] = t
    half = b_pad // 2

    def add_count(slot, qi, wt):
        if packed:
            mult = 1.0 if qi < half else _PACK_FIELD
            w2[slot, b_pad + qi % half] += wt * mult
        else:
            w2[slot, b_pad + qi] += wt

    for qi, i in enumerate(q_idx):
        if i is None:
            continue
        kind = kinds[i]
        narrow = kind in NARROW_KINDS
        n_gates = 0
        gate_idf = 0.0
        for g in plans[i].groups:
            # multi-clause MUST groups are uncountable (any-of match);
            # leaving them out of the count loosens but never breaks
            # the bound — such plans are classified "upper"
            count_group = g.occur is Occur.MUST and len(g.clauses) == 1
            if count_group and not narrow:
                nmust[qi] += 1.0
            for c in g.clauses:
                field = FACET_FIELD_KEY if c.is_facet else c.field
                t = tid_of.get((field, c.term))
                if g.occur is Occur.MUST_NOT:
                    if t is None:
                        continue
                    if narrow:
                        # score-lane exclusion: any match goes hard
                        # negative, below every gate/zero threshold
                        w2[terms[t], qi] += W_MUSTNOT
                    else:
                        add_count(terms[t], qi, -64.0)
                    continue
                if kind == "gate" and count_group:
                    # facet MUST: GATE_BIG in the lane (facet entries
                    # contribute exactly 1.0), real idf on the shift.
                    # An absent facet term means nothing can pass the
                    # gate threshold — matches the empty result the
                    # boolean semantics require.
                    n_gates += 1
                    df = stats.facet_doc_freq(c.term)
                    gate_idf += float(idf(df, stats.doc_count)) * c.boost
                    if t is not None:
                        w2[terms[t], qi] += GATE_BIG
                    continue
                if t is None:
                    continue
                slot = terms[t]
                if count_group and not narrow:
                    add_count(slot, qi, 1.0)
                if c.is_facet:
                    df = stats.facet_doc_freq(c.term)
                    wv = float(idf(df, stats.doc_count)) * c.boost
                    if count_group and kind == "shift":
                        # constant facet score moves to the host-side
                        # shift so scores>0 == "some SHOULD matched"
                        shifts[i] = shifts.get(i, 0.0) + wv
                    else:
                        w2[slot, qi] += wv
                else:
                    df = stats.doc_freq(c.field, c.term)
                    w2[slot, qi] += float(
                        bm25_weight(df, stats.doc_count, c.boost, k1)
                    )
        if kind == "gate":
            nmust[qi] = (n_gates - 0.5) * GATE_BIG
            shifts[i] = gate_idf - n_gates * GATE_BIG
    return w2, nmust, tid_arr


def _effective_kinds(plans, kinds, q_idx, wide):
    """Per-batch staging kinds.  In a WIDE batch the narrow score-lane
    tricks are unavailable (the kernel extracts counts, and nm means
    "required count", not a score threshold), so narrow kinds restate as
    their counted equivalents: "neg" -> "exact" (MUST_NOT as -64 counts),
    "gate" -> "exact"/"shift" (facet MUSTs as +1 counts with idf back on
    the score lane / host shift).  Pure plans stage narrow-style either
    way (no counts, nm=0)."""
    if not wide:
        return kinds
    eff: Dict[int, str] = {}
    for i in q_idx:
        if i is None:
            continue
        k = kinds[i]
        if k == "neg":
            k = "exact"
        elif k == "gate":
            n_should = sum(
                1
                for g in plans[i].groups
                if g.occur is Occur.SHOULD and g.clauses
            )
            k = "shift" if (plans[i].require_should and n_should) else "exact"
        eff[i] = k
    return eff


def _stream_cost(n_queries: int, n_terms: int, wide: bool, packed: bool):
    """Relative phase-A cost of one corpus stream, in work units
    (lanes x (u_pad + block docs)) plus the fixed per-stream overhead."""
    u = next((u for u in U_BUCKETS if n_terms <= u), U_BUCKETS[-1])
    b = next((v for v in B_BUCKETS if n_queries <= v), B_BUCKETS[-1])
    if packed:
        b2 = b + b // 2
    else:
        b2 = 2 * b if wide else b
    # penalty expressed at a typical u_pad of 512 (the fixed per-stream
    # overhead doesn't shrink with u)
    fixed = _STREAM_PENALTY_LANES * (512 + BM_BLOCK_DOCS)
    return b2 * (u + BM_BLOCK_DOCS) + fixed


def _merge_streams(batches, batch_terms, kinds, plans=None, tid_of=None):
    """Fuse a (narrow, wide) batch pair into ONE wide stream when the
    packed count lanes cost less than the second stream's fixed overhead
    plus its lanes (mixed workloads: the MUST stream folds into the
    narrow stream as extra packed lanes instead of a whole extra corpus
    stream).  Shared with the sharded engine: every shard runs the same
    lanes/streams, so the cost-model decision transfers verbatim
    (batch_sharded.batch_search_sharded).

    With ``plans``/``tid_of`` the cost model verifies bit-packability
    with a real :func:`_pack_order` dry run instead of assuming it;
    batches containing an "upper" plan never fold (merging would drag
    every query through the full raw-maxima host path, which the flop
    units don't price)."""
    pack_env = os.environ.get("FUGU_PACK_COUNTS", "")
    changed = True
    while changed:
        changed = False
        for a in range(len(batches)):
            for b in range(len(batches)):
                if a == b:
                    continue
                qa, qb = batches[a], batches[b]
                if any(kinds[i] == "upper" for i in qa + qb):
                    continue  # raw-maxima host path: never fold into it
                wa = any(kinds[i] not in NARROW_KINDS for i in qa)
                wb = any(kinds[i] not in NARROW_KINDS for i in qb)
                if wa == wb:
                    continue  # only narrow+wide pairs fold
                if len(qa) + len(qb) > B_PAD:
                    continue
                terms = set(batch_terms[a]) | set(batch_terms[b])
                if len(terms) > U_BUCKETS[-1]:
                    continue
                n_m = len(qa) + len(qb)
                b_m = next(v for v in B_BUCKETS if n_m <= v)
                # narrow queries lead: _pack_order pairs them freely
                merged = (qa + qb) if wb else (qb + qa)
                packable = pack_env != "0" and b_m >= _PACK_MIN_B
                if packable and plans is not None and tid_of is not None:
                    packable = (
                        _pack_order(merged, plans, tid_of, b_m // 2)
                        is not None
                    )
                cost_m = _stream_cost(n_m, len(terms), True, packable)
                cost_s = _stream_cost(
                    len(qa), len(batch_terms[a]), wa, False
                ) + _stream_cost(len(qb), len(batch_terms[b]), wb, False)
                if cost_m >= cost_s:
                    continue
                batches[a] = merged
                tmap: Dict[int, int] = {}
                for t in list(batch_terms[a]) + list(batch_terms[b]):
                    if t not in tmap:
                        tmap[t] = len(tmap)
                batch_terms[a] = tmap
                del batches[b], batch_terms[b]
                changed = True
                break
            if changed:
                break
    return batches, batch_terms


def _count_weight_map(plan: QueryPlan, tid_of) -> Dict[int, float]:
    """tid -> summed count-lane weight the wide staging writes for one
    plan (+1 per single-clause MUST, -64 per MUST_NOT clause)."""
    m: Dict[int, float] = {}
    for g in plan.groups:
        if g.occur is Occur.MUST_NOT:
            for c in g.clauses:
                field = FACET_FIELD_KEY if c.is_facet else c.field
                t = tid_of.get((field, c.term))
                if t is not None:
                    m[t] = m.get(t, 0.0) - 64.0
        elif g.occur is Occur.MUST and len(g.clauses) == 1:
            c = g.clauses[0]
            field = FACET_FIELD_KEY if c.is_facet else c.field
            t = tid_of.get((field, c.term))
            if t is not None:
                m[t] = m.get(t, 0.0) + 1.0
    return m


@functools.lru_cache(maxsize=4096)
def _bf16_exact(x: float) -> bool:
    # ml_dtypes numpy scalar — NOT jnp.bfloat16(x), which builds a device
    # array and syncs on float()
    import ml_dtypes

    return float(np.float32(x).astype(ml_dtypes.bfloat16)) == x


def _pack_order(q_idx, plans, tid_of, half):
    """Reorder a wide batch so count lanes can bit-pack two queries.

    The query at position j (j < half) shares a count lane with the one
    at position half + j; a term both write lands as lo + FIELD * hi in
    ONE bf16 weight, which must round-trip exactly (e.g. two paired
    MUSTs on the same term -> 4097: not representable).  Greedy
    first-fit pairing plus a pair-splitting repair pass; returns the
    reordered q_idx (None = pad lane keeping pair geometry) or None when
    no safe arrangement fits (caller stages unpacked)."""
    maps = {i: _count_weight_map(plans[i], tid_of) for i in q_idx}
    for m in maps.values():
        for w in m.values():
            if not (_bf16_exact(w) and _bf16_exact(w * _PACK_FIELD)):
                return None

    def ok(lo_i, hi_i):
        mh = maps[hi_i]
        for t, wl in maps[lo_i].items():
            wh = mh.get(t)
            if wh is not None and not _bf16_exact(wl + _PACK_FIELD * wh):
                return False
        return True

    lo: List[int] = []
    hi: List[Optional[int]] = []
    for i in q_idx:
        for j in range(len(lo)):
            if hi[j] is None and ok(lo[j], i):
                hi[j] = i
                break
        else:
            lo.append(i)
            hi.append(None)
    pairs = [(l, h) for l, h in zip(lo, hi) if h is not None]
    solos = [l for l, h in zip(lo, hi) if h is None]
    # repair: two leftover solos can displace into an existing pair
    # ((l,h) + s1 + s2 -> (l,s1) + (s2,h): one lane slot freed)
    while len(pairs) + len(solos) > half and len(solos) >= 2:
        repaired = False
        for si in range(len(solos)):
            for sj in range(len(solos)):
                if si == sj:
                    continue
                for pi, (l, h) in enumerate(pairs):
                    if ok(l, solos[si]) and ok(solos[sj], h):
                        pairs[pi] = (l, solos[si])
                        pairs.append((solos[sj], h))
                        for idx in sorted((si, sj), reverse=True):
                            solos.pop(idx)
                        repaired = True
                        break
                if repaired:
                    break
            if repaired:
                break
        if not repaired:
            return None
    if len(pairs) + len(solos) > half:
        return None
    lo_side = [l for l, _ in pairs] + solos
    lo_side += [None] * (half - len(lo_side))
    out = lo_side + [h for _, h in pairs]
    while out and out[-1] is None:
        out.pop()
    return out


def batch_search(
    segment: Segment,
    plans: Sequence[QueryPlan],
    stats,
    limits: Sequence[int],
    min_batch: int = MIN_BATCH,
) -> List[Optional[List[Tuple[float, int]]]]:
    """Two-phase batch search; per-plan result limits.

    Returns one entry per plan; None marks plans this path does not
    handle (callers run those through the single-phase engine).  Phase A
    is limit-independent, so plans with different limits share the same
    corpus streams; phase-B waves group by limit.  Fewer than
    ``min_batch`` eligible plans return all-None (one corpus stream
    needs a real batch to pay off).
    """
    from fugu_tpu.ops.pallas_scorer import MAX_K

    results: List[Optional[List[Tuple[float, int]]]] = [None] * len(plans)

    kinds = {}
    from fugu_tpu.ops.scoring import has_nonpositive_weight

    for i, p in enumerate(plans):
        if limits[i] > MAX_K:
            continue
        kind = _classify(p)
        if kind is not None and has_nonpositive_weight(p, stats):
            kind = None  # 'scores > 0 == matched' breaks; host fallback
        if kind is not None:
            kinds[i] = kind
    # narrow-kind plans (pure/neg/gate) batch first so they ride narrow
    # (no-count) streams; the count lanes double phase A's lane work and
    # only count-needing batches should pay for them
    elig = sorted(kinds, key=lambda i: (kinds[i] not in NARROW_KINDS, i))
    # a corpus stream + candidate staging needs a real batch to pay off,
    # whatever the limit
    if len(elig) < max(min_batch, 1):
        return results

    #: FUGU_TIMING=1 prints a per-call phase breakdown to stderr
    #: (dispatch / maxima fetch / candidate math / wave1 / wave2)
    _timing = os.environ.get("FUGU_TIMING") == "1"
    _t = time.perf_counter() if _timing else 0.0

    pack = segment.block_major(stats)
    k1 = plans[elig[0]].k1
    batches, batch_terms = plan_batches(plans, elig, kinds, pack.tid_of)
    if os.environ.get("FUGU_MERGE_STREAMS", "1") != "0":
        batches, batch_terms = _merge_streams(
            batches, batch_terms, kinds, plans, pack.tid_of
        )

    nb = pack.n_blocks
    nb_pad = _nb_pad(nb)
    offs = pad_sub_offs(pack.sub_offs, nb_pad)
    n_terms_pad = n_terms_bucket(pack.n_terms)

    pending = []
    shifts: Dict[int, float] = {}  # "shift" plans: constant facet score
    for q_idx, terms in zip(batches, batch_terms):
        u_pad = next((u for u in U_BUCKETS if len(terms) <= u), None)
        if u_pad is None:
            continue  # single over-wide query set: single-phase fallback
        b_pad = next(v for v in B_BUCKETS if len(q_idx) <= v)
        wide = any(kinds[i] not in NARROW_KINDS for i in q_idx)
        eff = _effective_kinds(plans, kinds, q_idx, wide)
        # bit-pack two queries' count columns per lane when the saved
        # lanes drop a whole 128-wide tile (b_pad=256: 512 -> 384)
        packed = False
        pack_env = os.environ.get("FUGU_PACK_COUNTS", "")
        if wide and pack_env != "0" and (
            b_pad >= _PACK_MIN_B or pack_env == "force"
        ):
            order = _pack_order(q_idx, plans, pack.tid_of, b_pad // 2)
            if order is not None:
                q_idx = order
                packed = True
        # lane-concat [weights | must-counts]: one kernel matmul serves
        # both the score sum and the constraint count (wide batches only)
        w2, nmust, tid_arr = stage_batch_weights(
            plans, eff, q_idx, terms, stats, pack.tid_of, b_pad, wide,
            k1, shifts, packed=packed,
        )
        fine = _fine_for_stream(q_idx, limits)
        fn = _get_phasea(nb_pad, b_pad, wide, packed, fine, n_terms_pad)
        amax = fn(
            jnp.asarray(offs),
            pack.d_doc,
            pack.d_tid,
            pack.d_con,
            jnp.asarray(w2, dtype=jnp.bfloat16),
            jnp.asarray(tid_arr),
            jnp.asarray(nmust),
        )
        if any(i is not None and kinds[i] == "upper" for i in q_idx):
            # "upper" bounds need the raw per-block maxima on the host
            # (wave-1 ordering + the post-wave-1 re-threshold), so this
            # batch ships the full [NB, B] array
            pending.append(("full", q_idx, amax, fine))
        else:
            # compact path: kth + margin threshold computed on device,
            # only a bit-packed candidate mask + counts cross to the host
            k_top = min(128, nb_pad * fine)
            shift_v = np.zeros(b_pad, dtype=np.float32)
            limidx = np.full(b_pad, -1, dtype=np.int32)
            margin_v = np.zeros(b_pad, dtype=np.float32)
            for qi, i in enumerate(q_idx):
                if i is None:
                    continue
                shift_v[qi] = shifts.get(i, 0.0)
                limidx[qi] = limits[i] - 1 if limits[i] <= k_top else -1
                # key on the EFFECTIVE staging kind: a "gate" plan folded
                # into a wide stream restages as shift/exact (no GATE_BIG
                # terms in its maxima), so the gate quantization margin
                # would only loosen its threshold for nothing
                if eff[i] == "gate":
                    margin_v[qi] = GATE_MARGIN
            post = _get_postproc(nb_pad, b_pad, fine)
            packed = post(
                amax,
                jnp.asarray(shift_v),
                jnp.asarray(limidx),
                jnp.asarray(margin_v),
            )
            pending.append(("compact", q_idx, packed, fine))

    if _timing:
        _now = time.perf_counter()
        print(f"[timing] phaseA dispatch: {(_now - _t) * 1e3:.1f}ms"
              f" ({len(pending)} streams)", file=sys.stderr)
        _t = _now

    # phase B: per-query candidate 2048-blocks from the maxima
    from fugu_tpu.ops.pallas_scorer import BLOCK as B_BLOCK

    sub_per_big = B_BLOCK // BM_BLOCK_DOCS
    # candidate indices arrive at each stream's own FINE granularity
    # ((512/fine)-doc slices); fine_of remembers it for the "upper"
    # two-wave re-threshold
    fine_of: Dict[int, int] = {}

    def run_wave(idxs: List[int], lists: Dict[int, np.ndarray]):
        """One batched block-scorer wave, grouped by per-plan limit; all
        limit groups dispatch before any fetch so their device work
        overlaps."""
        from fugu_tpu.ops.pallas_scorer import (
            pallas_search_begin,
            pallas_search_collect,
        )

        out: Dict[int, Optional[List[Tuple[float, int]]]] = {}
        by_limit: Dict[int, List[int]] = {}
        for i in idxs:
            by_limit.setdefault(limits[i], []).append(i)
        groups = list(by_limit.items())
        handles = [
            pallas_search_begin(
                segment,
                [plans[i] for i in ii],
                stats,
                lim,
                block_lists={j: lists[i] for j, i in enumerate(ii)},
            )
            for lim, ii in groups
        ]
        for (lim, ii), sub in zip(groups, pallas_search_collect(handles)):
            for j, i in enumerate(ii):
                out[i] = sub[j]
        return out

    def thresh_of(kth: float) -> float:
        return kth - abs(kth) * MARGIN_REL - MARGIN_ABS

    cols: Dict[int, np.ndarray] = {}
    wave1_idx: List[int] = []
    wave1_lists: Dict[int, np.ndarray] = {}
    # one overlapped transfer for all phase-A outputs
    it = iter(jax_setup.fetch_np([arr for _tag, _q, arr, _ in pending]))
    if _timing:
        _now = time.perf_counter()
        print(f"[timing] phaseA kernel+fetch: {(_now - _t) * 1e3:.1f}ms",
              file=sys.stderr)
        _t = _now
    for tag, q_idx, _a, fine in pending:
        fine_sub = sub_per_big * fine
        if tag == "compact":
            buf = next(it)     # [NB*F/16 + 1, b_pad] int32
            packed, count = buf[:-1], buf[-1]
            for qi, i in enumerate(q_idx):
                if i is None:
                    continue
                if count[qi] == 0:
                    results[i] = []  # no doc scores any positive clause
                    continue
                cand = _unpack_mask(packed[:, qi], nb * fine)
                wave1_lists[i] = np.unique(cand // fine_sub).astype(
                    np.int64
                )
                wave1_idx.append(i)
            continue
        amax = next(it)[:nb].reshape(nb * fine, -1)  # [NB*F, b_pad]
        for qi, i in enumerate(q_idx):
            if i is None:
                continue
            col = amax[:, qi]
            if i in shifts:  # add back the constant MUST-facet score
                col = np.where(np.isfinite(col), col + shifts[i], col)
            finite = col[np.isfinite(col)]
            if len(finite) == 0:
                results[i] = []  # no doc scores any positive clause
                continue
            lim = limits[i]
            if kinds[i] != "upper":
                # "pure"/"exact": maxima are achievable doc scores, so
                # kth-of-maxima is a valid lower bound — one wave
                kth = (
                    np.partition(-finite, lim - 1)[lim - 1] * -1
                    if len(finite) >= lim
                    else -np.inf
                )
                cand = np.nonzero(col >= thresh_of(kth))[0]
                wave1_lists[i] = np.unique(cand // fine_sub).astype(np.int64)
            else:
                # "upper": maxima are only upper bounds; wave 1 scores
                # the best-bounded big-blocks to establish kth
                cols[i] = col
                fine_of[i] = fine
                n_big = (len(col) + fine_sub - 1) // fine_sub
                big_u = np.full(n_big * fine_sub, NEG_INF, dtype=col.dtype)
                big_u[: len(col)] = col
                big_u = big_u.reshape(n_big, fine_sub).max(axis=1)
                order = np.argsort(-big_u, kind="stable")
                take = order[: ROUND1_BLOCKS]
                wave1_lists[i] = np.sort(take[np.isfinite(big_u[take])]).astype(
                    np.int64
                )
            wave1_idx.append(i)

    if _timing:
        _now = time.perf_counter()
        _n_cand = sum(len(v) for v in wave1_lists.values())
        print(f"[timing] candidate math: {(_now - _t) * 1e3:.1f}ms"
              f" ({_n_cand} wave1 blocks / {len(wave1_idx)} queries)",
              file=sys.stderr)
        _t = _now

    if not wave1_idx:
        return results
    wave1 = run_wave(wave1_idx, wave1_lists)
    if _timing:
        _now = time.perf_counter()
        print(f"[timing] wave1: {(_now - _t) * 1e3:.1f}ms", file=sys.stderr)
        _t = _now

    wave2_idx: List[int] = []
    wave2_lists: Dict[int, np.ndarray] = {}
    for i in wave1_idx:
        hits1 = wave1[i]
        if hits1 is None:  # block kernel declined: hand back to caller
            results[i] = None
            continue
        if kinds[i] != "upper":
            results[i] = hits1
            continue
        lim = limits[i]
        col = cols[i]
        kth = hits1[lim - 1][0] if len(hits1) >= lim else -np.inf
        cand = np.nonzero(col >= thresh_of(kth))[0] if np.isfinite(kth) else (
            np.nonzero(np.isfinite(col))[0]
        )
        rest = np.setdiff1d(
            np.unique(cand // (sub_per_big * fine_of[i])).astype(np.int64),
            wave1_lists[i],
        )
        if len(rest) == 0:
            results[i] = hits1[:lim]
        else:
            wave2_idx.append(i)
            wave2_lists[i] = rest

    if _timing and wave2_idx:
        _n2 = sum(len(v) for v in wave2_lists.values())
        print(f"[timing] wave2 pending: {_n2} blocks / {len(wave2_idx)}"
              " queries", file=sys.stderr)
    if wave2_idx:
        wave2 = run_wave(wave2_idx, wave2_lists)
        if _timing:
            _now = time.perf_counter()
            print(f"[timing] wave2: {(_now - _t) * 1e3:.1f}ms",
                  file=sys.stderr)
            _t = _now
        for i in wave2_idx:
            hits2 = wave2[i]
            if hits2 is None:
                results[i] = None
                continue
            # waves partition doc space; (-score, doc) re-rank reproduces
            # the single-phase kernel's global tie-break exactly
            merged = list(wave1[i]) + list(hits2)
            merged.sort(key=lambda sd: (-sd[0], sd[1]))
            results[i] = merged[: limits[i]]
    return results
