"""Multi-device search: doc-range sharding + per-shard top-k + merge.

The reference is strictly single-process with no distribution of any kind
(SURVEY.md §2c); this module is the scale-out path per BASELINE config
#5.  It has only run on virtual CPU devices (tests, __graft_entry__.py):

- a segment's docs are partitioned into contiguous id ranges, one per
  device of a 1-D ``jax.sharding.Mesh`` ("d" axis = the data-parallel
  analog: doc-id-range sharding of postings across chips)
- each device holds its shard's entry pack (sharded device_put along the
  leading axis) and a per-shard clause table (starts/lens differ per
  shard; BM25 weights are global — idf/avg statistics are index-wide)
- under ``shard_map`` every device scores its local postings with the
  same kernel as the single-chip path, then the per-shard top-k
  (score, global doc id) pairs ride an ``all_gather`` and a
  final top-k merges them; shard order preserves the doc-ascending
  tiebreak

The same code runs on a real multi-chip mesh or a CPU-faked
``xla_force_host_platform_device_count`` mesh (tests / dryrun).
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from fugu_tpu.index.segment import DOC_SENTINEL, FACET_FIELD_KEY, Segment
from fugu_tpu.ops import buckets
from fugu_tpu.ops.scoring import NEG_INF, top_k_lowest
from fugu_tpu.query import Occur, QueryPlan, bm25_denom_consts, bm25_weight, idf


def make_mesh(n_devices: Optional[int] = None, n_slices: int = 1) -> Mesh:
    """Device mesh for doc-range sharding.

    ``n_slices > 1`` builds a 2-D ("dcn", "d") mesh with an outer and an
    inner axis; the top-k merge gathers hierarchically (inner axis
    first, then only k survivors per group cross the outer one).  The
    2-D shape follows a multi-slice pod topology; over all-to-all links
    it is only another grid.
    """
    devs = jax.devices()
    n = n_devices or len(devs)
    if n_slices > 1:
        if n % n_slices:
            raise ValueError(f"{n} devices not divisible by {n_slices} slices")
        arr = np.array(devs[:n]).reshape(n_slices, n // n_slices)
        return Mesh(arr, axis_names=("dcn", "d"))
    return Mesh(np.array(devs[:n]), axis_names=("d",))


def shard_axes(mesh: Mesh) -> tuple:
    """All mesh axis names, outer-to-inner — doc ranges shard over the
    flattened device grid regardless of mesh rank."""
    return tuple(mesh.axis_names)


def shard_bounds(doc_count: int, n_shards: int) -> list:
    """Canonical doc-range split.  ONE definition: phase-B candidate
    block ids assume ShardedBlockMajor and PallasShardedPack split docs
    identically, so both must derive bounds from here."""
    n = max(doc_count, 1)
    return [(s * n) // n_shards for s in range(n_shards + 1)]


class ShardedPack:
    """A segment's entry pack partitioned by doc-id range across a mesh."""

    def __init__(self, segment: Segment, mesh: Mesh):
        self.mesh = mesh
        self.segment = segment
        d = mesh.devices.size
        self.n_shards = d
        n = max(segment.doc_count, 1)
        bounds = shard_bounds(segment.doc_count, d)
        self.bounds = bounds
        self.shard_starts = np.array(bounds[:-1], dtype=np.int32)
        self.shard_counts = np.array(
            [bounds[s + 1] - bounds[s] for s in range(d)], dtype=np.int32
        )

        real = segment.e_doc[: segment.n_entries]
        tf = segment.e_tf[: segment.n_entries]
        fid = segment.e_fid[: segment.n_entries]

        # per-shard packs: entries fall into exactly one doc range; term
        # order is preserved, so per-shard postings stay doc-sorted
        shard_sel = [
            (real >= bounds[s]) & (real < bounds[s + 1]) for s in range(d)
        ]
        packs = []
        self._term_tables: List[Dict[str, Dict[str, Tuple[int, int]]]] = []
        max_posting = 1
        for s in range(d):
            sel = shard_sel[s]
            sdoc = (real[sel] - bounds[s]).astype(np.int32)
            spk = (tf[sel] | (fid[sel] << 24)).astype(np.int32)
            # rebuild the term table for this shard
            table: Dict[str, Dict[str, Tuple[int, int]]] = {}
            csel = np.cumsum(sel)  # entries kept up to (and incl.) index i
            for field, tmap in segment.terms.items():
                ftab: Dict[str, Tuple[int, int]] = {}
                for term, info in tmap.items():
                    lo, hi = info.start, info.start + info.doc_freq
                    kept_before = int(csel[lo - 1]) if lo > 0 else 0
                    kept = int(csel[hi - 1]) - kept_before if hi > 0 else 0
                    if kept:
                        ftab[term] = (kept_before, kept)
                        max_posting = max(max_posting, kept)
                table[field] = ftab
            self._term_tables.append(table)
            packs.append((sdoc, spk))
        #: per-shard host (doc, packed) arrays — the Pallas sharded stager
        #: searchsorteds block tables over these (parallel.pallas_sharded)
        self.host_packs = packs

        from fugu_tpu.index.segment import _pow2_bucket

        pad = buckets.l_bucket(max_posting)
        e_max = _pow2_bucket(max(len(p[0]) for p in packs) + pad)
        self.e_max = e_max
        stacked_doc = np.full((d, e_max), DOC_SENTINEL, dtype=np.int32)
        stacked_pk = np.zeros((d, e_max), dtype=np.int32)
        n_words = max((n + 31) // 32, 1)
        tomb = np.zeros((d, n_words), dtype=np.uint32)
        dead = np.nonzero(segment.tombstones)[0]
        for s, (sdoc, spk) in enumerate(packs):
            stacked_doc[s, : len(sdoc)] = sdoc
            stacked_pk[s, : len(spk)] = spk
            local = dead[(dead >= bounds[s]) & (dead < bounds[s + 1])] - bounds[s]
            np.bitwise_or.at(tomb[s], local >> 5, np.uint32(1) << (local & 31))

        shard_spec = NamedSharding(mesh, P(shard_axes(mesh), None))
        self.d_doc = jax.device_put(stacked_doc, shard_spec)
        self.d_pk = jax.device_put(stacked_pk, shard_spec)
        self.d_tomb = jax.device_put(tomb, shard_spec)
        self.d_offsets = jax.device_put(
            self.shard_starts.reshape(d, 1), shard_spec
        )
        #: total staged device bytes (split across the mesh's d chips;
        #: residency accounts hbm_bytes / d per chip — engine/named_index)
        self.hbm_bytes = (
            stacked_doc.nbytes + stacked_pk.nbytes + tomb.nbytes
        )

    def stage(self, plan: QueryPlan, stats, t_pad: int):
        """Per-shard clause operands [D, T] + global masks, or None."""
        if plan.host_only:
            return None
        d = self.n_shards
        starts = np.zeros((d, t_pad), dtype=np.int32)
        lens = np.zeros((d, t_pad), dtype=np.int32)
        weights = np.zeros(t_pad, dtype=np.float32)
        c1 = np.ones(t_pad, dtype=np.float32)
        c2 = np.zeros(t_pad, dtype=np.float32)
        gbits = np.zeros(t_pad, dtype=np.uint32)
        must = mustnot = should = 0
        k1, b = float(plan.k1), float(plan.b)
        ti = 0
        has_constraints = any(g.occur is not Occur.SHOULD for g in plan.groups)
        if has_constraints and len(plan.groups) > 32:
            return None
        for gi, group in enumerate(plan.groups):
            bit = 1 << (gi % 32)
            if group.occur is Occur.MUST:
                must |= bit
            elif group.occur is Occur.MUST_NOT:
                mustnot |= bit
            else:
                should |= bit
            for clause in group.clauses:
                if clause.is_facet:
                    df = stats.facet_doc_freq(clause.term)
                    if df == 0:
                        continue
                    weights[ti] = float(idf(df, stats.doc_count)) * clause.boost * (1.0 + k1)
                    c1[ti] = k1
                    c2[ti] = 0.0
                    field, term = FACET_FIELD_KEY, clause.term
                else:
                    df = stats.doc_freq(clause.field, clause.term)
                    if df == 0:
                        continue
                    avg = stats.avg_fieldnorm(clause.field)
                    weights[ti] = float(
                        bm25_weight(df, stats.doc_count, clause.boost, k1)
                    )
                    cc1, cc2 = bm25_denom_consts(avg, k1, b)
                    c1[ti], c2[ti] = cc1, cc2
                    field, term = clause.field, clause.term
                for s in range(d):
                    entry = self._term_tables[s].get(field, {}).get(term)
                    if entry:
                        starts[s, ti], lens[s, ti] = entry
                gbits[ti] = bit
                ti += 1
        if ti == 0:
            return None
        if ti > t_pad:
            raise ValueError("too many clauses for bucket")
        if must and not plan.require_should:
            should = 0
        return starts, lens, weights, c1, c2, gbits, must, mustnot, should, has_constraints


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "t_pad", "l_pad", "k", "need_bits"),
)
def _sharded_topk(
    e_doc,
    e_tffid,
    tomb,
    offsets,
    starts,
    lens,
    weights,
    c1,
    c2,
    gbits,
    must,
    mustnot,
    should,
    *,
    mesh,
    t_pad,
    l_pad,
    k,
    need_bits,
):
    def local(e_doc, e_tffid, tomb, offsets, starts, lens):
        from fugu_tpu.ops.scoring import segment_topk_merge_impl

        top, docs = segment_topk_merge_impl(
            e_doc[0], e_tffid[0], tomb[0],
            starts[0], lens[0], weights, c1, c2, gbits,
            must, mustnot, should,
            t_pad=t_pad, l_pad=l_pad, k=k, need_bits=need_bits,
        )
        kk = min(k, t_pad * l_pad)
        gdoc = jnp.where(
            top > NEG_INF, docs + offsets[0, 0], jnp.int32(DOC_SENTINEL)
        )
        # hierarchical per-shard top-k merge: gather the inner axis first,
        # keep only kk survivors, then the outer axis carries just kk
        # entries per group
        for ax in reversed(shard_axes(mesh)):
            all_scores = jax.lax.all_gather(top, ax).reshape(-1)
            all_docs = jax.lax.all_gather(gdoc, ax).reshape(-1)
            top, mi = top_k_lowest(all_scores, kk)
            gdoc = all_docs[mi]
        return top[None, :], gdoc[None, :]

    spec = P(shard_axes(mesh), None)
    return shard_map(
        local,
        mesh=mesh,
        in_specs=(spec, spec, spec, spec, spec, spec),
        out_specs=(P(None, None), P(None, None)),
        check_vma=False,
    )(e_doc, e_tffid, tomb, offsets, starts, lens)


def sharded_search(
    pack: ShardedPack, plan: QueryPlan, stats, limit: int
) -> Optional[List[Tuple[float, int]]]:
    """[(score, global_doc_id)] or None (oracle fallback).

    (No has_nonpositive_weight gate: the merge-network kernel matches by
    group bits, not ``scores > 0`` — sign-correct under tombstone-
    inflated negative idf, pinned by test_sharded_tombstones.)"""
    n_clauses = sum(len(g.clauses) for g in plan.groups)
    t_pad = buckets.t_bucket(max(n_clauses, 1))
    staged = pack.stage(plan, stats, t_pad)
    if staged is None:
        return None
    starts, lens, weights, c1, c2, gbits, must, mustnot, should, need_bits = staged
    max_len = int(lens.max()) if lens.size else 1
    if max_len == 0:
        return []
    if t_pad > 16 or max_len > buckets.L_BUCKETS[-1]:
        return None
    if limit > buckets.K_BUCKETS[-1]:
        return None  # beyond the extraction ladder: don't silently truncate
    l_pad = buckets.l_bucket(max_len)
    k = buckets.k_bucket(limit)

    shard_spec = NamedSharding(pack.mesh, P(shard_axes(pack.mesh), None))
    scores, docs = _sharded_topk(
        pack.d_doc,
        pack.d_pk,
        pack.d_tomb,
        pack.d_offsets,
        jax.device_put(starts, shard_spec),
        jax.device_put(lens, shard_spec),
        jnp.asarray(weights),
        jnp.asarray(c1),
        jnp.asarray(c2),
        jnp.asarray(gbits),
        jnp.uint32(must),
        jnp.uint32(mustnot),
        jnp.uint32(should),
        mesh=pack.mesh,
        t_pad=t_pad,
        l_pad=l_pad,
        k=k,
        need_bits=need_bits,
    )
    scores = np.asarray(scores)[0]
    docs = np.asarray(docs)[0]
    keep = np.isfinite(scores) & (docs != DOC_SENTINEL)
    hits = [(float(s), int(d)) for s, d in zip(scores[keep], docs[keep])]
    # device floats -> oracle-exact host floats before the final
    # ranking (device sums run in another order); docs are global ids
    from fugu_tpu.ops.rescore import rescore_hits

    return rescore_hits(pack.segment, plan, stats, hits)[:limit]
