"""Sharded phrase stream: the brute-force corpus-position phrase engine
(ops/phrase_stream) under a device mesh.

The sweep is block-parallel (no cross-block state), so doc-range
sharding is the same move as phase A's (parallel/batch_sharded):

- **ShardedTokenStream**: each shard holds the forward token stream of
  ITS doc range (local doc ids via ops/phrase_stream.build_stream_arrays
  with [doc_lo, doc_hi); per-field term ordinals are segment-global, so
  the per-batch operands stay replicated).
- **Sweep under shard_map**: every device sweeps its local stream with
  the unchanged sweep; per-fine-block maxima/classes stay
  device-sharded along the block axis, and the phrase postprocessor
  (_get_phrase_post) runs as a plain jit over the sharded array —
  GSPMD inserts the cross-shard gather for the global top-K; only the
  [B, 3K+1] bound buffer crosses to the host.
- **Host phase B**: global padded fine ids map to per-shard doc windows
  (clamped at shard bounds so a tail block never overlaps the next
  shard's block 0), then the same margin-free ordered verification
  (ops/phrase_stream._rescore_blocks with lo/hi tables) reproduces
  bit-exact results.

Reference behavior: phrases inside Tantivy via QueryParser ->
PhraseQuery (`/root/reference/src/db/search.rs:112`); the reference has
no distribution of any kind (SURVEY.md §2c).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from fugu_tpu import jax_setup
from fugu_tpu.index.segment import BM_BLOCK_DOCS, Segment
from fugu_tpu.ops.batch_scorer import BM_FINE_DOCS, FINE_PER_BLOCK, _nb_pad
from fugu_tpu.ops.phrase_stream import (
    PHRASE_MIN_BATCH,
    SENT_ROW,
    _get_phrase_post,
    _phrase_callable,
    _rescore_blocks,
    build_stream_arrays,
    eligible_phrase,
    split_dispatch_groups,
    stage_group_weights,
)
from fugu_tpu.parallel.sharded import Mesh, shard_axes, shard_bounds
from fugu_tpu.query import PhraseClause, QueryPlan

jax_setup.configure()


class ShardedTokenStream:
    """Per-shard token streams of one (segment, field) over a mesh's
    doc ranges, stacked [d, ...] and device_put along the shard axis."""

    def __init__(self, segment: Segment, field: str, mesh: Mesh, stats):
        self.mesh = mesh
        self.segment = segment
        self.field = field
        d = mesh.devices.size
        self.n_shards = d
        bounds = shard_bounds(segment.doc_count, d)
        self.bounds = bounds

        shards = []
        nb_max = 1
        for s in range(d):
            nb_max = max(
                nb_max,
                (bounds[s + 1] - bounds[s] + BM_BLOCK_DOCS - 1)
                // BM_BLOCK_DOCS,
            )
        self.nb_pad = _nb_pad(nb_max)
        for s in range(d):
            arrs = build_stream_arrays(
                segment,
                field,
                stats,
                doc_lo=bounds[s],
                doc_hi=bounds[s + 1],
                nb_pad=self.nb_pad,
            )
            if not arrs.ok:
                self.ok = False
                return
            shards.append(arrs)
        self.ok = True
        self.tid_of = shards[0].tid_of
        self.nbs = [a.n_blocks for a in shards]

        rows_max = max(len(a.pack) for a in shards)
        st_tok = np.full((d, rows_max), SENT_ROW, dtype=np.int32)
        st_cv = np.zeros((d, self.nb_pad * 1024), dtype=np.float32)
        st_fid = np.zeros((d, self.nb_pad * 1024), dtype=np.int32)
        st_offs = np.zeros((d, self.nb_pad + 1), dtype=np.int32)
        for s, a in enumerate(shards):
            st_tok[s, : len(a.pack)] = a.pack
            st_cv[s] = a.cv
            st_fid[s] = a.fid
            st_offs[s] = a.chunk_offs

        from fugu_tpu.ops import residency

        total = (
            st_tok.nbytes + st_cv.nbytes + st_fid.nbytes + st_offs.nbytes
        )
        # per-CHIP residency accounting: the stacked arrays split across
        # d devices, and the budget models one chip's HBM
        residency.reserve(
            ("stok", id(segment), field),
            max(total // d, 1),
            segment,
            _evict_sharded_stream,
            kind="token_stream",
        )
        spec = NamedSharding(mesh, P(shard_axes(mesh), None))
        self.d_tok = jax.device_put(st_tok, spec)
        self.d_cv = jax.device_put(st_cv, spec)
        self.d_fid = jax.device_put(st_fid, spec)
        self.d_offs = jax.device_put(st_offs, spec)
        self.hbm_bytes = total

        # global padded fine id -> clamped doc windows, monotone in id:
        # shard s, local fine f covers global docs [bounds[s] + f*FINE,
        # min(..., bounds[s+1])); padded local blocks get the empty
        # window [bounds[s+1], bounds[s+1]) so monotonicity holds
        nb2_local = self.nb_pad * FINE_PER_BLOCK
        gid = np.arange(d * nb2_local, dtype=np.int64)
        s_of = gid // nb2_local
        rem = gid % nb2_local
        b_lo = np.asarray(bounds, dtype=np.int64)
        lo = b_lo[s_of] + rem * BM_FINE_DOCS
        hi = np.minimum(lo + BM_FINE_DOCS, b_lo[s_of + 1])
        lo = np.minimum(lo, b_lo[s_of + 1])
        self.lo_table = lo
        self.hi_table = hi


def _evict_sharded_stream(segment: Segment) -> None:
    cache = getattr(segment, "_sharded_token_stream", None)
    if isinstance(cache, dict):
        cache.clear()


def get_sharded_token_stream(
    segment: Segment, field: str, mesh: Mesh, stats
) -> Optional[ShardedTokenStream]:
    """Cached per-(field, mesh) ShardedTokenStream (same fingerprint
    scheme as the single-chip get_token_stream; residency-managed)."""
    from fugu_tpu.ops import residency

    if field not in segment.pos_offsets:
        return None
    cache = getattr(segment, "_sharded_token_stream", None)
    if not isinstance(cache, dict):
        cache = {}
        object.__setattr__(segment, "_sharded_token_stream", cache)
    key = (field, id(mesh))
    hit = cache.get(key)
    if hit is not None and hit[0] == stats.fingerprint:
        residency.touch(("stok", id(segment), field))
        return hit[1]
    pack = ShardedTokenStream(segment, field, mesh, stats)
    if not pack.ok:
        return None
    cache[key] = (stats.fingerprint, pack)
    if not residency.contains(("stok", id(segment), field)):
        cache.pop(key, None)
    return pack


_SHARDED_PHRASE_CACHE: dict = {}


def _get_sharded_phrase(mesh, nb_pad, b_pad, kmax, smax):
    """jit(shard_map(phrase sweep) -> phrase postproc): per-shard
    sweeps emit block-sharded maxima; the postproc's global top_k
    gathers the block axis over the mesh collectives and only the
    [B, 3K+1] bound buffer leaves the device."""
    key = (mesh, nb_pad, b_pad, kmax, smax)
    fn = _SHARDED_PHRASE_CACHE.get(key)
    if fn is not None:
        return fn
    call = _phrase_callable(nb_pad, kmax, smax)
    d = mesh.devices.size
    axes = shard_axes(mesh)
    post = _get_phrase_post(d * nb_pad, b_pad)

    def local(offs, tok, cv, fid, want, wp, slop):
        return call(offs[0], tok[0], cv[0], fid[0], want, wp, slop)

    spec2 = P(axes, None)
    sharded = shard_map(
        local,
        mesh=mesh,
        in_specs=(
            spec2, spec2, spec2, spec2, P(None, None), P(None), P(None),
        ),
        out_specs=(P(axes, None, None), P(axes, None, None)),
        check_vma=False,
    )

    @jax.jit
    def run(offs, tok, cv, fid, want, wp, slop):
        amax, acls = sharded(offs, tok, cv, fid, want, wp, slop)
        return post(amax, acls)

    _SHARDED_PHRASE_CACHE[key] = run
    return run


def phrase_stream_sharded_begin(
    segment: Segment,
    mesh: Mesh,
    plans: Sequence[QueryPlan],
    stats,
    limits: Sequence[int],
    min_batch: int = PHRASE_MIN_BATCH,
):
    """Sharded analog of ops/phrase_stream.phrase_stream_begin: stage
    and dispatch eligible phrase plans over the mesh; returns a handle
    for :func:`phrase_stream_sharded_collect`."""
    pre: List[Optional[List[Tuple[float, int]]]] = [None] * len(plans)
    staged: List[Tuple[int, PhraseClause]] = []
    by_field: Dict[str, List[int]] = {}
    clauses: Dict[int, PhraseClause] = {}
    for i, plan in enumerate(plans):
        pc = eligible_phrase(plan)
        if pc is None or limits[i] > 128:
            continue
        clauses[i] = pc
        by_field.setdefault(pc.field, []).append(i)

    dispatches = []
    for field, idxs in sorted(by_field.items()):
        pack = get_sharded_token_stream(segment, field, mesh, stats)
        if pack is None:
            continue
        run = []
        for i in idxs:
            if any(t not in pack.tid_of for t in clauses[i].terms):
                pre[i] = []  # absent terms match nothing
            else:
                run.append(i)
        if len(run) < max(min_batch, 1):
            for i in run:
                del clauses[i]  # host path serves these
            continue
        for q_idx, smax in split_dispatch_groups(run, clauses):
            want, wp, slop, b_pad, kmax = stage_group_weights(
                pack.tid_of, q_idx, clauses, stats, smax
            )
            fn = _get_sharded_phrase(mesh, pack.nb_pad, b_pad, kmax, smax)
            buf = fn(
                pack.d_offs,
                pack.d_tok,
                pack.d_cv,
                pack.d_fid,
                jnp.asarray(want),
                jnp.asarray(wp),
                jnp.asarray(slop),
            )
            dispatches.append((q_idx, buf, pack))
            for i in q_idx:
                staged.append((i, clauses[i]))
    return (pre, staged, dispatches, segment, stats, list(limits))


def phrase_stream_sharded_collect(handle):
    """Fetch per-query ordered block bounds (already globally top-K'd
    over the mesh) and host-verify in bound order — results are aligned
    with begin's plans (None = not served here) and bit-identical to
    the single-chip engine/oracle."""
    pre, staged, dispatches, segment, stats, limits = handle
    results = list(pre)
    if not dispatches:
        return results

    bufs = jax_setup.fetch_np([b for _q, b, _p in dispatches])
    clause_of = dict(staged)
    for (q_idx, _b, pack), buf in zip(dispatches, bufs):
        k = (buf.shape[1] - 1) // 3
        nb2_global = len(pack.lo_table)
        for qi, i in enumerate(q_idx):
            row = buf[qi]
            count = int(row[-1])
            if count == 0:
                results[i] = []
                continue
            ids = row[k : 2 * k].astype(np.int64)
            cls = row[2 * k : 3 * k].astype(np.int64)
            take = min(count, k)
            keep = ids[:take] < nb2_global
            results[i] = _rescore_blocks(
                segment,
                clause_of[i],
                stats,
                ids[:take][keep],
                cls[:take][keep],
                count > k,
                limits[i],
                lo_table=pack.lo_table,
                hi_table=pack.hi_table,
            )
    return results


def batch_phrase_search_sharded(
    segment: Segment,
    mesh: Mesh,
    plans: Sequence[QueryPlan],
    stats,
    limits: Sequence[int],
    min_batch: int = PHRASE_MIN_BATCH,
) -> List[Optional[List[Tuple[float, int]]]]:
    """Synchronous begin+collect (None entries = caller's host path)."""
    return phrase_stream_sharded_collect(
        phrase_stream_sharded_begin(
            segment, mesh, plans, stats, limits, min_batch
        )
    )
