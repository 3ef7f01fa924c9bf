"""Batched block scorer under shard_map: the sharded query engine.

Runs the block scorer (ops/pallas_scorer) over a doc-range-sharded mesh
with the whole query batch in each dispatch — the same per-device
program as the single-device engine (SURVEY.md §2c: per-shard top-k +
collective merge).

Layout per mesh device (one doc-range shard):

- the shard's entry pack (doc, tf|fid) as rows of stacked [D, E] arrays
- the shard's tombstones as per-block rows of 0/1 flags
- per-(query, shard) block tables: starts/counts per clause per block,
  computed host-side with one cached ``searchsorted`` per (shard, term)

Under ``shard_map`` each device scores its local blocks; the per-shard
top-k (score, global doc) lists merge by hierarchical ``all_gather`` —
inner mesh axis first, then only k survivors per group cross the outer
axis.

The reference has no distribution of any kind (one process, one writer
mutex — /root/reference/src/db/core.rs:211,300-302).  This path has only
run on virtual CPU devices (tests, __graft_entry__.py's dry run).
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from fugu_tpu.index.segment import DOC_SENTINEL, Segment, _pow2_bucket
from fugu_tpu.ops import buckets
from fugu_tpu.ops.pallas_scorer import (
    BLOCK,
    DENSE_ELEMS,
    MAX_K,
    NB_BUCKETS,
    _INT_MAX,
    build_scorer_call,
    nb_bucket,
    plan_block_tables,
)
from fugu_tpu import jax_setup
from fugu_tpu.ops.scoring import ClauseArgs, mask_i32, top_k_lowest
from fugu_tpu.parallel.sharded import Mesh, ShardedPack, shard_axes
from fugu_tpu.query import QueryPlan


class PallasShardedPack(ShardedPack):
    """ShardedPack + the block scorer's per-shard device arrays."""

    def __init__(self, segment: Segment, mesh: Mesh):
        super().__init__(segment, mesh)
        d = self.n_shards
        max_entries = max(len(p[0]) for p in self.host_packs)
        e_max = _pow2_bucket(max_entries + 1)
        stacked_doc = np.full((d, e_max), DOC_SENTINEL, dtype=np.int32)
        stacked_pk = np.zeros((d, e_max), dtype=np.int32)
        for s, (sdoc, spk) in enumerate(self.host_packs):
            stacked_doc[s, : len(sdoc)] = sdoc
            stacked_pk[s, : len(spk)] = spk

        # per-shard tombstone flags, one BLOCK-doc row per block, padded
        # to the max shard block count
        self.max_shard_docs = int(self.shard_counts.max()) if d else 1
        self.n_blocks = max((self.max_shard_docs + BLOCK - 1) // BLOCK, 1)
        flags = np.zeros((d, self.n_blocks, BLOCK), dtype=np.int32)
        dead = np.nonzero(segment.tombstones)[0]
        for s in range(d):
            lo, hi = self.bounds[s], self.bounds[s + 1]
            local = dead[(dead >= lo) & (dead < hi)] - lo
            flags[s].reshape(-1)[local] = 1

        spec = NamedSharding(mesh, P(shard_axes(mesh), None))
        spec3 = NamedSharding(mesh, P(shard_axes(mesh), None, None))
        self.p_doc = jax.device_put(stacked_doc, spec)
        self.p_pk = jax.device_put(stacked_pk, spec)
        self.p_flags = jax.device_put(flags, spec3)
        self.hbm_bytes = getattr(self, "hbm_bytes", 0) + (
            stacked_doc.nbytes + stacked_pk.nbytes + flags.nbytes
        )
        #: searchsorted memo per shard: (start, len) -> block offsets
        self._offs_caches = [dict() for _ in range(d)]

    def stage_pallas(self, plan: QueryPlan, stats, t_pad: int):
        """Per-shard staged clause args, or None (host fallback).

        Reuses ShardedPack.stage for the per-shard (start, len) tables
        and global weights, then re-wraps each shard's row as ClauseArgs
        for the block-table stager.
        """
        staged = self.stage(plan, stats, t_pad)
        if staged is None:
            return None
        starts, lens, weights, c1, c2, gbits, must, mustnot, should, need = staged
        shard_args = [
            ClauseArgs(
                starts=starts[s],
                lens=lens[s],
                weights=weights,
                c1=c1,
                c2=c2,
                gbits=gbits.astype(np.uint32),
            )
            for s in range(self.n_shards)
        ]
        return shard_args, must, mustnot, should, need


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "t_pad", "nb_pad", "k", "b_pad", "need_bits"),
)
def _sharded_scorer(
    nblocks,      # int32[D, B]
    block_ids,    # int32[D, B, NB]
    starts,       # int32[D, B, NB*T]
    counts,       # int32[D, B, NB*T]
    weights,      # f32[B, T]     (global: BM25 stats are index-wide)
    c1,
    c2,
    gbits,        # int32[B, T]
    masks,        # int32[B, 3]
    e_doc,        # int32[D, E]
    e_tffid,      # int32[D, E]
    flags,        # int32[D, NBLK, BLOCK]
    offsets,      # int32[D, 1]  global doc base per shard
    *,
    mesh,
    t_pad,
    nb_pad,
    k,
    b_pad,
    need_bits,
):
    call = build_scorer_call(t_pad, nb_pad, k, b_pad, need_bits)

    def local(
        nblocks, block_ids, starts, counts,
        weights, c1, c2, gbits, masks,
        e_doc, e_tffid, flags, offsets,
    ):
        top_s, top_d = call(
            nblocks[0], block_ids[0], starts[0], counts[0],
            weights, c1, c2, gbits, masks,
            e_doc[0], e_tffid[0], flags[0],
        )  # [B, 1, kk]
        top_s = top_s[:, 0, :]
        top_d = top_d[:, 0, :]
        gdoc = jnp.where(
            top_d != _INT_MAX, top_d + offsets[0, 0], jnp.int32(_INT_MAX)
        )
        # hierarchical top-k merge: inner axis first, the outer one
        # carries only k survivors per group
        kk = top_s.shape[-1]
        for ax in reversed(shard_axes(mesh)):
            all_s = jax.lax.all_gather(top_s, ax)   # [Dax, B, K]
            all_d = jax.lax.all_gather(gdoc, ax)
            flat_s = jnp.moveaxis(all_s, 0, 1).reshape(all_s.shape[1], -1)
            flat_d = jnp.moveaxis(all_d, 0, 1).reshape(all_d.shape[1], -1)
            top_s, mi = top_k_lowest(flat_s, kk)
            gdoc = jnp.take_along_axis(flat_d, mi, axis=1)
        return top_s[None], gdoc[None]

    axes = shard_axes(mesh)
    dspec = P(axes, None)
    dspec3 = P(axes, None, None)
    rep2 = P(None, None)
    return shard_map(
        local,
        mesh=mesh,
        in_specs=(
            dspec, dspec3, dspec3, dspec3,
            rep2, rep2, rep2, rep2, rep2,
            dspec, dspec, dspec3, dspec,
        ),
        out_specs=(P(None, None, None), P(None, None, None)),
        check_vma=False,
    )(
        nblocks, block_ids, starts, counts,
        weights, c1, c2, gbits, masks,
        e_doc, e_tffid, flags, offsets,
    )


def pallas_sharded_search_batch(
    pack: PallasShardedPack,
    plans: Sequence[QueryPlan],
    stats,
    limit: int,
    block_lists: Optional[dict] = None,
) -> List[Optional[List[Tuple[float, int]]]]:
    """Batched multi-chip search; one entry per plan, None = fallback.

    ``block_lists`` (plan index -> per-shard list of allowed LOCAL block
    ids) restricts each query to a caller-proven candidate set — the
    sharded two-phase engine (parallel/batch_sharded) passes the blocks
    whose phase-A maxima can still reach the kth score."""
    results: List[Optional[List[Tuple[float, int]]]] = [None] * len(plans)
    if limit > MAX_K:
        return results
    # strict <: at limit == bucket extract one ladder step above so host
    # rescoring sees slack candidates (see ops/pallas_scorer.py)
    k = buckets.k_extract(limit) or MAX_K
    d = pack.n_shards
    from fugu_tpu.ops.scoring import has_nonpositive_weight

    staged = []
    for i, plan in enumerate(plans):
        if plan.host_only:
            continue
        if has_nonpositive_weight(plan, stats):
            continue  # 'scores > 0 == matched' breaks; host fallback
        n_clauses = sum(len(g.clauses) for g in plan.groups)
        t_pad = max(buckets.t_bucket(max(n_clauses, 1)), 4)
        if t_pad > 16 or len(plan.groups) > 32:
            continue
        st = pack.stage_pallas(plan, stats, t_pad)
        if st is None:
            # stage can only return None here when every clause had
            # df == 0 (>32-group plans were filtered above): no doc can
            # score, so the empty result is exact
            results[i] = []
            continue
        staged.append((i, t_pad) + st)

    if not staged:
        return results

    by_t: dict = {}
    for item in staged:
        # item = (i, t_pad, shard_args, must, mustnot, should, need_bits)
        by_t.setdefault((item[1], item[6]), []).append(item)

    nb_max = NB_BUCKETS[-1]
    pending = []
    for (t_pad, need_bits), items in by_t.items():
        rows = []
        for (i, _t, shard_args, must, mustnot, should, _nb) in items:
            tables = []
            max_nb = 0
            for s in range(d):
                st, ct, nonempty = plan_block_tables(
                    pack.host_packs[s][0],
                    shard_args[s],
                    t_pad,
                    pack.n_blocks,
                    must,
                    pack._offs_caches[s],
                )
                if block_lists is not None and i in block_lists:
                    nonempty = np.intersect1d(nonempty, block_lists[i][s])
                tables.append((st, ct, nonempty))
                max_nb = max(max_nb, len(nonempty))
            # shards with more nonempty blocks than the widest NB bucket
            # split into block-SLICE rows (each row takes the next nb_max
            # blocks of every shard); slices partition doc space, so the
            # host concat + re-rank below reproduces the global order
            n_slices = max(1, -(-max_nb // nb_max))
            for r in range(n_slices):
                sl = [
                    (st, ct, nonempty[r * nb_max : (r + 1) * nb_max])
                    for st, ct, nonempty in tables
                ]
                sl_max = max(len(t[2]) for t in sl)
                rows.append(
                    (i, shard_args, must, mustnot, should, sl, max(sl_max, 1))
                )
        if not rows:
            continue
        # group rows by their own nb bucket (mirrors the single-device
        # dispatcher): one global max-nb_pad would force every row into
        # the widest signature and its small query batches
        rows_by_nb: Dict[int, list] = {}
        for r in rows:
            rows_by_nb.setdefault(nb_bucket(max(r[6], 1)), []).append(r)
        for nb_pad, nrows in sorted(rows_by_nb.items()):
            cap = max(1, DENSE_ELEMS // (nb_pad * t_pad * BLOCK))
            b_max = max([x for x in buckets.B_BUCKETS if x <= cap] or [1])
            b_pad = min(buckets.b_bucket(len(nrows)), b_max)

            pos = 0
            while pos < len(nrows):
                chunk = nrows[pos : pos + b_pad]
                pos += len(chunk)
                nblocks = np.zeros((d, b_pad), dtype=np.int32)
                block_ids = np.zeros((d, b_pad, nb_pad), dtype=np.int32)
                startsA = np.zeros((d, b_pad, nb_pad, t_pad), dtype=np.int32)
                countsA = np.zeros((d, b_pad, nb_pad, t_pad), dtype=np.int32)
                weights = np.zeros((b_pad, t_pad), dtype=np.float32)
                c1 = np.ones((b_pad, t_pad), dtype=np.float32)
                c2 = np.zeros((b_pad, t_pad), dtype=np.float32)
                gbits = np.full((b_pad, t_pad), -1, dtype=np.int32)
                masks = np.zeros((b_pad, 3), dtype=np.int32)
                for bi, (i, shard_args, must, mustnot, should, tables, _m) in enumerate(
                    chunk
                ):
                    weights[bi] = shard_args[0].weights
                    c1[bi] = shard_args[0].c1
                    c2[bi] = shard_args[0].c2
                    for t in range(t_pad):
                        bits = int(shard_args[0].gbits[t])
                        gbits[bi, t] = bits.bit_length() - 1 if bits else -1
                    masks[bi] = (
                        mask_i32(must), mask_i32(mustnot), mask_i32(should)
                    )
                    for s in range(d):
                        st, ct, nonempty = tables[s]
                        nb = len(nonempty)
                        nblocks[s, bi] = nb
                        block_ids[s, bi, :nb] = nonempty
                        startsA[s, bi, :nb] = st[nonempty]
                        countsA[s, bi, :nb] = ct[nonempty]

                spec = NamedSharding(pack.mesh, P(shard_axes(pack.mesh), None))
                spec3 = NamedSharding(
                    pack.mesh, P(shard_axes(pack.mesh), None, None)
                )
                top_s, top_d = _sharded_scorer(
                    jax.device_put(nblocks, spec),
                    jax.device_put(block_ids, spec3),
                    jax.device_put(
                        startsA.reshape(d, b_pad, nb_pad * t_pad), spec3
                    ),
                    jax.device_put(
                        countsA.reshape(d, b_pad, nb_pad * t_pad), spec3
                    ),
                    jnp.asarray(weights),
                    jnp.asarray(c1),
                    jnp.asarray(c2),
                    jnp.asarray(gbits),
                    jnp.asarray(masks),
                    pack.p_doc,
                    pack.p_pk,
                    pack.p_flags,
                    pack.d_offsets,
                    mesh=pack.mesh,
                    t_pad=t_pad,
                    nb_pad=nb_pad,
                    k=k,
                    b_pad=b_pad,
                    need_bits=need_bits,
                )
                pending.append((chunk, top_s, top_d))

    partial: dict = {}
    # one overlapped transfer for all dispatches
    flat = jax_setup.fetch_np([a for _c, s, dd in pending for a in (s, dd)])
    fetched = list(zip(flat[0::2], flat[1::2]))
    for (chunk, _s, _d), (top_s, top_d) in zip(pending, fetched):
        top_s = top_s[0]
        top_d = top_d[0]
        for bi, (i, *_rest) in enumerate(chunk):
            keep = np.isfinite(top_s[bi]) & (top_d[bi] != _INT_MAX)
            partial.setdefault(i, []).extend(
                (float(s), int(dd))
                for s, dd in zip(top_s[bi][keep], top_d[bi][keep])
            )
    from fugu_tpu.ops.rescore import rescore_hits

    for i, hits in partial.items():
        # block-slice rows partition doc space; device floats are then
        # replaced with oracle-exact host floats before the final
        # ranking (device sums run in another order); docs are global ids
        results[i] = rescore_hits(pack.segment, plans[i], stats, hits)[
            :limit
        ]
    return results
