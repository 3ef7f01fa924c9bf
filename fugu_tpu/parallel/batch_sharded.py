"""Sharded two-phase batch engine: phase A under shard_map + pruned
sharded re-scoring.

The flagship single-chip engine (ops/batch_scorer) streams the whole
corpus once per query batch and re-scores only the blocks whose exact
per-block maxima can still reach the kth score.  This module runs the
SAME two phases over a device mesh (SURVEY.md §2c — doc-range sharding,
the DP analog):

- **Sharded block-major packs**: each shard holds the block-major pack
  of ITS doc range (local doc ids, local 512-doc blocks) but with
  GLOBAL term ids (index/segment.py ``entry_term_contribs``), so the
  per-batch weight matrix W and term table stay replicated — staging is
  identical to the single-chip engine.
- **Phase A under shard_map**: every device streams its local pack
  through the unchanged phase-A kernel
  (ops/batch_scorer.phasea_callable), emitting local [nbs_pad, F, B]
  maxima; the outputs stay device-sharded along the block axis and the
  device-side kth-threshold postprocessor (_get_postproc) runs as a
  plain jit over the sharded array — GSPMD inserts the cross-shard
  gather for the global top-k, and only the bit-packed candidate mask
  crosses to the host.
- **Phase B**: per-shard candidate block lists feed the sharded block
  scorer (parallel/pallas_sharded ``block_lists``), which already
  merges per-shard top-k over the mesh collectives.

Kinds "pure"/"exact"/"shift" run in one wave exactly as the single-chip
engine (the kth-of-maxima is a global bound — per-shard maxima are
gathered before thresholding, so the mask semantics are identical).
"upper"-kind plans return None and fall back to the plain sharded block
scorer, which is exact.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from fugu_tpu import jax_setup
from fugu_tpu.index.segment import (
    BM_BLOCK_DOCS,
    Segment,
    _pow2_bucket,
    entry_term_contribs,
    pack_block_major,
)
from fugu_tpu.ops.batch_scorer import (
    B_BUCKETS,
    GATE_MARGIN,
    MIN_BATCH,
    NARROW_KINDS,
    U_BUCKETS,
    _PACK_MIN_B,
    BM_SUBS_PER_BLOCK,
    _classify,
    _effective_kinds,
    _fine_for_stream,
    _get_postproc,
    _merge_streams,
    _nb_pad,
    _pack_order,
    _unpack_mask,
    n_terms_bucket,
    pad_sub_offs,
    phasea_callable,
    plan_batches,
    stage_batch_weights,
)
from fugu_tpu.parallel.pallas_sharded import pallas_sharded_search_batch
from fugu_tpu.parallel.sharded import Mesh, shard_axes, shard_bounds
from fugu_tpu.query import QueryPlan

jax_setup.configure()


class ShardedBlockMajor:
    """Per-shard block-major packs over a segment's doc ranges.

    Shard bounds match parallel/sharded.ShardedPack exactly (the same
    (s*n)//d split), so phase-B candidate blocks map 1:1 onto the
    sharded block scorer's local block space."""

    def __init__(self, segment: Segment, mesh: Mesh, stats):
        self.mesh = mesh
        self.segment = segment
        d = mesh.devices.size
        self.n_shards = d
        bounds = shard_bounds(segment.doc_count, d)
        self.bounds = bounds

        e = segment.n_entries
        docs = segment.e_doc[:e]
        tid_entry, contrib, self.tid_of, self.n_terms = entry_term_contribs(
            segment, stats
        )

        packs = []
        self.nbs: List[int] = []  # real local block count per shard
        for s in range(d):
            sel = (docs >= bounds[s]) & (docs < bounds[s + 1])
            local = (docs[sel] - bounds[s]).astype(np.int64)
            arrs = pack_block_major(
                local,
                tid_entry[sel],
                contrib[sel],
                max(bounds[s + 1] - bounds[s], 1),
            )
            packs.append(arrs)
            self.nbs.append(arrs[4])

        self.nbs_pad = _nb_pad(max(self.nbs))
        e_max = _pow2_bucket(max(len(p[0]) for p in packs))
        import ml_dtypes

        st_doc = np.full((d, e_max), -1, dtype=np.int32)
        st_tid = np.full((d, e_max), -1, dtype=np.int32)
        # bf16, matching the single-chip BlockMajorPack (the phase-A
        # kernel's con lane is bf16; MARGIN_REL budgets the rounding)
        st_con = np.zeros((d, e_max), dtype=ml_dtypes.bfloat16)
        offs = np.zeros(
            (d, self.nbs_pad * BM_SUBS_PER_BLOCK + 1), dtype=np.int32
        )
        for s, (bm_doc, bm_tid, bm_con, sub_offs, _nb_s) in enumerate(packs):
            st_doc[s, : len(bm_doc)] = bm_doc
            st_tid[s, : len(bm_tid)] = bm_tid
            st_con[s, : len(bm_con)] = bm_con
            offs[s] = pad_sub_offs(sub_offs, self.nbs_pad)
        self.n_terms_pad = n_terms_bucket(self.n_terms)

        spec = NamedSharding(mesh, P(shard_axes(mesh), None))
        self.d_doc = jax.device_put(st_doc, spec)
        self.d_tid = jax.device_put(st_tid, spec)
        self.d_con = jax.device_put(st_con, spec)
        self.d_offs = jax.device_put(offs, spec)
        #: total staged device bytes (split across d chips; residency
        #: accounts hbm_bytes / d per chip — engine/named_index)
        self.hbm_bytes = (
            st_doc.nbytes + st_tid.nbytes + st_con.nbytes + offs.nbytes
        )


_SHARDED_PHASEA_CACHE: dict = {}


def _get_sharded_phasea(mesh, nbs_pad, b_pad, wide, packed, fine,
                        n_terms_pad):
    """jit(shard_map(phase-A kernel)) + the device postprocessor over the
    gathered maxima, emitting only the packed candidate mask."""
    key = (mesh, nbs_pad, b_pad, wide, packed, fine, n_terms_pad)
    fn = _SHARDED_PHASEA_CACHE.get(key)
    if fn is not None:
        return fn
    call = phasea_callable(nbs_pad, b_pad, wide, packed, fine, n_terms_pad)
    d = mesh.devices.size
    axes = shard_axes(mesh)
    post = _get_postproc(d * nbs_pad, b_pad, fine)

    def local(offs, doc, tid, con, w, tids, nm):
        return call(offs[0], doc[0], tid[0], con[0], w, tids, nm)

    spec2 = P(axes, None)
    sharded = shard_map(
        local,
        mesh=mesh,
        in_specs=(spec2, spec2, spec2, spec2, P(None, None), P(None),
                  P(None)),
        out_specs=P(axes, None, None),
        check_vma=False,
    )

    @jax.jit
    def run(offs, doc, tid, con, w, tids, nm, shift, limidx, margin):
        amax = sharded(offs, doc, tid, con, w, tids, nm)  # [d*nbs, F, B]
        # the postproc's global top_k gathers the block axis over the
        # mesh collectives (GSPMD); only the packed mask leaves sharded
        return post(amax, shift, limidx, margin)

    _SHARDED_PHASEA_CACHE[key] = run
    return run


def batch_search_sharded(
    pack2: ShardedBlockMajor,
    spack,
    plans: Sequence[QueryPlan],
    stats,
    limits: Sequence[int],
    min_batch: int = MIN_BATCH,
) -> List[Optional[List[Tuple[float, int]]]]:
    """Two-phase sharded batch search; None entries = caller fallback
    (the plain sharded block scorer / per-plan XLA sharded path).  Fewer
    than ``min_batch`` eligible plans return all-None."""
    from fugu_tpu.ops.pallas_scorer import BLOCK as B_BLOCK
    from fugu_tpu.ops.pallas_scorer import MAX_K

    results: List[Optional[List[Tuple[float, int]]]] = [None] * len(plans)

    kinds = {}
    from fugu_tpu.ops.scoring import has_nonpositive_weight

    for i, p in enumerate(plans):
        if limits[i] > MAX_K:
            continue
        kind = _classify(p)
        # "upper" needs raw maxima host-side (two waves); the plain
        # sharded scorer handles those exactly
        if kind is not None and has_nonpositive_weight(p, stats):
            kind = None  # 'scores > 0 == matched' breaks; host fallback
        if kind is not None and kind != "upper":
            kinds[i] = kind
    # narrow kinds first so plan_batches' narrow/wide boundary doesn't
    # split the batch at every kind flip (mirrors the single-chip sort)
    elig = sorted(kinds, key=lambda i: (kinds[i] not in NARROW_KINDS, i))
    if len(elig) < max(min_batch, 1):
        return results

    k1 = plans[elig[0]].k1
    batches, batch_terms = plan_batches(plans, elig, kinds, pack2.tid_of)
    if os.environ.get("FUGU_MERGE_STREAMS", "1") != "0":
        # every shard runs the same lanes/streams, so the single-chip
        # flop model's merge decision transfers verbatim
        batches, batch_terms = _merge_streams(
            batches, batch_terms, kinds, plans, pack2.tid_of
        )

    d = pack2.n_shards
    nbs_pad = pack2.nbs_pad
    nb_tot = d * nbs_pad

    pending = []
    shifts: Dict[int, float] = {}
    for q_idx, terms in zip(batches, batch_terms):
        u_pad = next((u for u in U_BUCKETS if len(terms) <= u), None)
        if u_pad is None:
            continue  # over-wide union: caller fallback
        b_pad = next(v for v in B_BUCKETS if len(q_idx) <= v)
        wide = any(kinds[i] not in NARROW_KINDS for i in q_idx)
        eff = _effective_kinds(plans, kinds, q_idx, wide)
        is_packed = False
        pack_env = os.environ.get("FUGU_PACK_COUNTS", "")
        if wide and pack_env != "0" and (
            b_pad >= _PACK_MIN_B or pack_env == "force"
        ):
            order = _pack_order(q_idx, plans, pack2.tid_of, b_pad // 2)
            if order is not None:
                q_idx = order
                is_packed = True
        w2, nmust, tid_arr = stage_batch_weights(
            plans, eff, q_idx, terms, stats, pack2.tid_of, b_pad, wide,
            k1, shifts, packed=is_packed,
        )
        fine = _fine_for_stream(q_idx, limits)
        k_top = min(128, nb_tot * fine)
        shift_v = np.zeros(b_pad, dtype=np.float32)
        limidx = np.full(b_pad, -1, dtype=np.int32)
        margin_v = np.zeros(b_pad, dtype=np.float32)
        for qi, i in enumerate(q_idx):
            if i is None:
                continue
            shift_v[qi] = shifts.get(i, 0.0)
            limidx[qi] = limits[i] - 1 if limits[i] <= k_top else -1
            # EFFECTIVE kind, as in batch_scorer: gate plans folded into
            # wide streams restage as shift/exact (no GATE_BIG terms),
            # so the gate quantization margin would only loosen their
            # thresholds for nothing
            if eff[i] == "gate":
                margin_v[qi] = GATE_MARGIN
        fn = _get_sharded_phasea(
            pack2.mesh, nbs_pad, b_pad, wide, is_packed, fine,
            pack2.n_terms_pad,
        )
        packed = fn(
            pack2.d_offs,
            pack2.d_doc,
            pack2.d_tid,
            pack2.d_con,
            jnp.asarray(w2, dtype=jnp.bfloat16),
            jnp.asarray(tid_arr),
            jnp.asarray(nmust),
            jnp.asarray(shift_v),
            jnp.asarray(limidx),
            jnp.asarray(margin_v),
        )
        pending.append((q_idx, packed, fine))

    if not pending:
        return results

    sub_per_big = B_BLOCK // BM_BLOCK_DOCS
    it = iter(jax_setup.fetch_np([p for _q, p, _f in pending]))
    wave_idx: List[int] = []
    wave_lists: Dict[int, List[np.ndarray]] = {}
    for q_idx, _p, fine in pending:
        buf = next(it)              # [nb_tot*F/16 + 1, b_pad] int32
        packed_np, count = buf[:-1], buf[-1]
        for qi, i in enumerate(q_idx):
            if i is None:
                continue
            if count[qi] == 0:
                results[i] = []  # no doc scores any positive clause
                continue
            fine_ids = _unpack_mask(packed_np[:, qi], nb_tot * fine)
            cand = np.unique(fine_ids // fine)  # 512-doc block ids
            # global index -> (shard, local 512-block) -> the sharded
            # block scorer's local 2048-doc block ids; per-shard padded
            # tail blocks (>= nbs[s]) are NEG_INF unless the query fell
            # back to a full sweep — drop them here either way
            per_shard: List[np.ndarray] = []
            for s in range(d):
                lb = cand[(cand >= s * nbs_pad) & (cand < (s + 1) * nbs_pad)]
                lb = lb - s * nbs_pad
                lb = lb[lb < pack2.nbs[s]]
                per_shard.append(
                    np.unique(lb // sub_per_big).astype(np.int64)
                )
            wave_lists[i] = per_shard
            wave_idx.append(i)

    if not wave_idx:
        return results

    by_limit: Dict[int, List[int]] = {}
    for i in wave_idx:
        by_limit.setdefault(limits[i], []).append(i)
    for lim, ii in by_limit.items():
        sub = pallas_sharded_search_batch(
            spack,
            [plans[i] for i in ii],
            stats,
            lim,
            block_lists={j: wave_lists[i] for j, i in enumerate(ii)},
        )
        for j, i in enumerate(ii):
            results[i] = sub[j]
    return results
