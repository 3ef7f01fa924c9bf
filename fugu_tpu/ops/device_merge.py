"""On-device segment merge: rebuild a merged posting pack in device memory.

The SURVEY §2b north star ("on-device segment merge-sort with tombstone
filtering") — the reference's counterpart is Tantivy's segment merger
running inside IndexWriter's background threads (`/root/reference/src/
db/core.rs:247-249`).  Here the compactor's host merge produces the
merged Segment (term dict, stored docs, positions — host-side state that
must be durable anyway), and THIS kernel rebuilds the merged segment's
**device pack** directly from the sources' HBM-resident packs, so a
freshly compacted index serves queries without re-uploading hundreds of
MB of postings through the host.

Everything is a fused XLA program over static (pow2-bucketed) shapes,
int32 end to end (pack sizes stay < 2^31 by construction):

1. **Gather plan** (host, tiny): the merge's (merged-term, segment) run
   decomposition (index/merge.py ``MergePlan``) — each output run is a
   contiguous slice of one source pack.  Per-entry indices are recovered
   on device with one ``searchsorted`` over the run table.
2. **Tombstone filtering + renumber** (device): live bits come from the
   merge's tombstone *snapshot* (uploaded words, NOT the packs' own
   tombstones — a delete racing the merge must not desync the pack from
   the merged term dictionary; padding docs are marked dead so they
   never count).  Doc remaps are per-segment ``cumsum(live) - 1 + base``
   computed on device.
3. **Stream compaction** (device): dead entries drop out via the
   monotone-gather idiom — output slot q reads the q-th live entry,
   located with ``searchsorted(cumsum(live), q+1)`` — no scatter, which
   keeps the whole program gather/cumsum-shaped (and XLA
   fuses the surrounding elementwise work).

The result is bit-identical to ``merged.device_pack()`` built from the
host merge (tests/test_device_merge.py asserts exact equality).
"""

from __future__ import annotations

from functools import partial
from typing import Sequence, Tuple

import numpy as np

from fugu_tpu import jax_setup
from fugu_tpu.index.segment import (
    DOC_SENTINEL,
    Segment,
    _pow2_bucket,
    pack_dead_bits,
    pack_entry_size,
    pack_word_size,
)
from fugu_tpu.index.merge import MergePlan

jax_setup.configure()

import jax
import jax.numpy as jnp

#: run-table padding for dst starts: sorts after any real entry index
_RUN_PAD = np.iinfo(np.int32).max


_pack_dead_bits = pack_dead_bits  # shared with Segment.device_pack


@partial(
    jax.jit,
    static_argnames=("e_pre", "e_pre_pad", "out_pad", "doc_pads"),
)
def _merge_packs(
    doc_all,        # int32[sum(pack_pads)]  concat source e_doc packs
    tffid_all,      # int32[sum(pack_pads)]  concat source e_tffid packs
    snap_words,     # uint32[sum(word_pads)] concat dead-bit words
    run_gsrc,       # int32[R_pad]  src start (global, pack-concat space)
    run_dst,        # int32[R_pad]  pre-compaction dst start (_RUN_PAD pad)
    run_seg,        # int32[R_pad]  source segment per run
    *,
    e_pre: int,
    e_pre_pad: int,
    out_pad: int,
    doc_pads: Tuple[int, ...],
):
    n_segs = len(doc_pads)
    word_pads = tuple(p // 32 for p in doc_pads)

    # per-segment live bits + renumber maps over the padded doc space
    # (padding docs carry dead bits, so counts and bases stay exact)
    lives = []
    w_off = 0
    for s in range(n_segs):
        w = snap_words[w_off : w_off + word_pads[s]]
        w_off += word_pads[s]
        d = jnp.arange(doc_pads[s], dtype=jnp.int32)
        bits = (w[d >> 5] >> (d & 31).astype(jnp.uint32)) & jnp.uint32(1)
        lives.append(bits == 0)
    live_doc = jnp.concatenate(lives)
    csums = []
    totals = []
    for s in range(n_segs):
        c = jnp.cumsum(lives[s].astype(jnp.int32))
        csums.append(c - 1)
        totals.append(c[-1])
    live_base = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), jnp.cumsum(jnp.stack(totals))]
    )[:-1]
    remap_doc = jnp.concatenate(
        [csums[s] + live_base[s] for s in range(n_segs)]
    )

    # 1. expand the run table: output slot p -> source pack index
    p = jnp.arange(e_pre_pad, dtype=jnp.int32)
    r = jnp.searchsorted(run_dst, p, side="right").astype(jnp.int32) - 1
    r = jnp.clip(r, 0, run_dst.shape[0] - 1)
    src = run_gsrc[r] + (p - run_dst[r])
    valid = p < e_pre
    src = jnp.where(valid, src, 0)
    doc = doc_all[src]
    tffid = tffid_all[src]
    seg = run_seg[r]

    # 2. tombstone filter + renumber (doc ids are segment-local; address
    # the concat doc space via the padded per-segment bases)
    doc_base = jnp.asarray(
        np.concatenate([[0], np.cumsum(doc_pads)[:-1]]).astype(np.int32)
    )
    gdoc = jnp.where(valid, doc_base[seg] + doc, 0)
    live = valid & live_doc[gdoc]
    ndoc = remap_doc[gdoc]

    # 3. stream-compact via monotone gather
    cum = jnp.cumsum(live.astype(jnp.int32))
    n_live = cum[-1]
    q = jnp.arange(out_pad, dtype=jnp.int32)
    j = jnp.searchsorted(cum, q + 1, side="left").astype(jnp.int32)
    j = jnp.minimum(j, e_pre_pad - 1)
    keep = q < n_live
    out_doc = jnp.where(keep, ndoc[j], jnp.int32(DOC_SENTINEL))
    out_tffid = jnp.where(keep, tffid[j], 0)
    return out_doc, out_tffid


def device_merge_entries(
    segments: Sequence[Segment],
    plan: MergePlan,
    merged: Segment,
):
    """Build ``merged``'s (e_doc, e_tffid) device arrays from the
    sources' resident packs — exactly the layout ``merged.device_pack()``
    would upload.  Tombstone words are built separately at attach time
    (:func:`attach_device_pack`) because the compactor may forward
    racing deletes into ``merged.tombstones`` after this runs.  Sources'
    packs are uploaded on demand if not already resident (cheap relative
    to re-uploading the merged pack from host).
    """
    packs = [s.device_pack() for s in segments]
    pack_pads = [int(p[0].shape[0]) for p in packs]
    # run_gsrc below is int32 over the CONCATENATED padded packs: a sum
    # past 2^31 would wrap negative and gather-clamp to 0, silently
    # building a corrupt merged pack.  Refuse loudly — the caller's
    # except branch falls back to the host-upload path.
    if sum(pack_pads) >= 2**31:
        raise ValueError(
            f"combined padded source packs ({sum(pack_pads)} entries) "
            "exceed int32 addressing; use the host upload path"
        )
    doc_all = jnp.concatenate([p[0] for p in packs])
    tffid_all = jnp.concatenate([p[1] for p in packs])
    pack_off = np.concatenate([[0], np.cumsum(pack_pads)[:-1]])

    # padded per-doc spaces: word arrays sized doc_pad/32 so the device
    # bit-expansion is shape-regular; padding docs are marked DEAD
    doc_pads = tuple(_pow2_bucket(max(s.doc_count, 32)) for s in segments)
    word_parts = []
    for i, (seg, snap) in enumerate(zip(segments, plan.tomb_snapshots)):
        dead = np.ones(doc_pads[i], dtype=bool)
        dead[: seg.doc_count] = snap
        word_parts.append(_pack_dead_bits(dead, doc_pads[i] // 32))
    snap_words = np.concatenate(word_parts)

    n_runs = len(plan.run_seg)
    r_pad = _pow2_bucket(max(n_runs, 8))
    run_gsrc = np.zeros(r_pad, dtype=np.int32)
    run_dst = np.full(r_pad, _RUN_PAD, dtype=np.int32)
    run_seg = np.zeros(r_pad, dtype=np.int32)
    run_gsrc[:n_runs] = (plan.run_src_start + pack_off[plan.run_seg]).astype(
        np.int32
    )
    run_dst[:n_runs] = plan.run_dst_start.astype(np.int32)
    run_seg[:n_runs] = plan.run_seg

    e_pre = int(
        (plan.run_dst_start[-1] + plan.run_len[-1]) if n_runs else 0
    )
    e_pre_pad = _pow2_bucket(max(e_pre, 32))
    # Segment.device_pack's sizing of the merged pack, via the shared
    # helper (shape drift = a divergent jit program per merged segment)
    out_pad = pack_entry_size(len(merged.e_doc))

    return _merge_packs(
        doc_all,
        tffid_all,
        jnp.asarray(snap_words),
        jnp.asarray(run_gsrc),
        jnp.asarray(run_dst),
        jnp.asarray(run_seg),
        e_pre=e_pre,
        e_pre_pad=e_pre_pad,
        out_pad=out_pad,
        doc_pads=doc_pads,
    )


def attach_device_pack(merged: Segment, entries: tuple) -> None:
    """Install device-merged (e_doc, e_tffid) on the merged segment so
    its first query skips the host->HBM pack upload.  Tombstone words
    are built here from the merged segment's CURRENT tombstones (any
    racing deletes the compactor forwarded are included) — a tiny
    upload, same layout as Segment.device_pack."""
    out_doc, out_tffid = entries
    n_words = pack_word_size(merged.doc_count)
    tomb_words = jnp.asarray(pack_dead_bits(merged.tombstones, n_words))
    merged._device_pack = (out_doc, out_tffid, tomb_words)
