"""Smoke run of the search engine on one GPU, through its normal entry
points, at the size of the headline corpus.

    python chip_smoke.py [--docs N]

One process, one card.  Each phase prints one JSON line; any failure
exits non-zero (no phase catches and continues):

1. device   — JAX's first device must be a GPU (nothing falls back to
   the CPU); prints its kind, the JAX version, the compile-cache
   directory and nvidia-smi's name and power limit.
2. load     — N MS MARCO-shaped passages (bench.msmarco_tokens: Zipf
   1.07 over 30k terms, Poisson(55) tokens per doc, 20 /source/*
   facets, seed 7) through DatasetManager -> Dataset.ingest in
   batches (the `POST /ingest` path), then Dataset.compact (the
   `/compact` path) to one segment per index, then the query path's
   device packs.
3. kernel:* — each device program of the query path compiled at real
   widths (phase A in its narrow, wide and packed lane layouts, the
   block scorer at 256 blocks and k=128, the phrase sweep at slop 0
   and 2), its compiled.memory_analysis(), and one comparison with the
   plain reference (ops/oracle.py) within the stated tolerances.
4. queries  — ~256 parsed query strings sent concurrently through
   server/batcher.SearchBatcher -> Dataset.search_many (the HTTP
   handlers' call), then 8 one at a time; every answer must equal a
   host Dataset(use_device=False) on the same directory (ids, order,
   f32 scores), and phase A, the block scorer and the phrase sweep
   must each have answered at least one query.

The last line is exactly
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.
Times printed on earlier lines are smoke readings, not benchmark
results.  The phases are importable (tests run 2-4 on the CPU at a
tiny size); only main() insists on a GPU.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))

NAMESPACE = "smoke"
SEED = 7


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}, default=str), flush=True)


def nvidia_smi() -> str:
    """The card's name and power limit, read by a child that stays off
    JAX."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def device_check():
    """Phase 1.  Returns JAX's first device; exits non-zero unless it is
    a GPU."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(
            f"chip_smoke: needs a GPU; JAX's first device is {dev.platform}",
            file=sys.stderr,
        )
        raise SystemExit(2)
    from fugu_tpu import jax_setup

    jax_setup.configure()
    smi = nvidia_smi()
    print(smi, flush=True)
    emit(
        "device",
        platform=dev.platform,
        kind=dev.device_kind,
        count=len(jax.devices()),
        jax=jax.__version__,
        compile_cache=jax.config.jax_compilation_cache_dir,
        nvidia_smi=smi,
    )
    return dev


# -- phase 2 ---------------------------------------------------------------


class Corpus:
    """The generated token stream, kept for drawing queries."""

    def __init__(self, words, starts, sources):
        self.words = words
        self.starts = starts
        self.sources = sources

    def adjacent(self, rng, n: int, gap: int = 1):
        """``n`` (word, word) pairs ``gap`` positions apart inside one
        doc — phrases that really occur."""
        out = []
        n_docs = len(self.starts) - 1
        while len(out) < n:
            d = int(rng.integers(0, n_docs))
            lo, hi = int(self.starts[d]), int(self.starts[d + 1])
            if hi - lo > gap:
                p = int(rng.integers(lo, hi - gap))
                out.append((str(self.words[p]), str(self.words[p + gap])))
        return out


def load_store(n_docs: int, data_dir: Path, batch: int = 100_000):
    """Phase 2.  -> (manager, dataset, corpus)."""
    from bench import msmarco_tokens
    from fugu_tpu.config import ServerConfig
    from fugu_tpu.engine.manager import DatasetManager
    from fugu_tpu.ops import residency
    from fugu_tpu.ops.phrase_stream import get_token_stream
    from fugu_tpu.records import ObjectRecord

    t0 = time.perf_counter()
    words, starts, sources = msmarco_tokens(n_docs, SEED)
    records = [
        ObjectRecord(
            id=f"d{i}",
            text=" ".join(words[starts[i] : starts[i + 1]]),
            facets=[f"/source/{int(sources[i])}"],
        )
        for i in range(n_docs)
    ]
    t1 = time.perf_counter()
    cfg = ServerConfig.with_defaults(str(data_dir), NAMESPACE)
    cfg.writer_memory_budget = 1 << 40  # one segment per ingest batch
    cfg.compaction = "off"              # compacted once, below
    mgr = DatasetManager(cfg)
    ds = mgr.get_or_create_dataset(NAMESPACE)
    for lo in range(0, n_docs, batch):
        ds.ingest(records[lo : lo + batch])
    t2 = time.perf_counter()
    ds.compact()
    t3 = time.perf_counter()
    docs = ds.docs()
    assert len(docs.segments) == 1 and docs.num_docs == n_docs, (
        len(docs.segments), docs.num_docs,
    )
    seg, stats = docs.segments[0], docs.stats()
    packs = [seg.device_pack(), seg.block_major(stats).d_doc]
    packs.append(get_token_stream(seg, "text", stats).d_tok)
    for p in packs:
        getattr(p, "block_until_ready", lambda: None)()
    t4 = time.perf_counter()
    res = residency.stats()
    emit(
        "load",
        docs=n_docs,
        postings=seg.n_entries,
        generate_s=round(t1 - t0, 3),
        ingest_s=round(t2 - t1, 3),
        compact_s=round(t3 - t2, 3),
        upload_s=round(t4 - t3, 3),
        device_pack_bytes=res["resident_bytes"],
        device_pack_bytes_by_kind=res["by_kind"],
        peak_bytes_in_use=_peak_bytes(),
    )
    return mgr, ds, Corpus(words, starts, sources)


def _peak_bytes():
    import jax

    return (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")


# -- phase 3 ---------------------------------------------------------------


def _memory(compiled) -> dict:
    m = compiled.memory_analysis()
    if m is None:
        return {}
    return {
        k: getattr(m, k)
        for k in (
            "generated_code_size_in_bytes",
            "argument_size_in_bytes",
            "output_size_in_bytes",
            "alias_size_in_bytes",
            "temp_size_in_bytes",
        )
        if hasattr(m, k)
    }


def _compile(fn, args):
    t0 = time.perf_counter()
    compiled = fn.lower(*args).compile()
    return compiled, round(time.perf_counter() - t0, 3)


def _run_s(compiled, args, repeat: int = 3):
    """(outputs, median wall seconds over ``repeat`` runs, each ended by
    block_until_ready)."""
    import jax

    times = []
    for _ in range(repeat):
        t0 = time.perf_counter()
        out = jax.block_until_ready(compiled(*args))
        times.append(time.perf_counter() - t0)
    return out, round(sorted(times)[len(times) // 2], 6)


def _oracle_slice_max(seg, plan, stats, slice_docs: int, n_slices: int):
    from fugu_tpu.ops import oracle

    scores, mask = oracle.score_segment(seg, plan, stats)
    v = np.full(n_slices * slice_docs, -np.inf, dtype=np.float32)
    v[: len(scores)] = np.where(mask, scores, -np.inf)
    return v.reshape(n_slices, slice_docs).max(axis=1)


def check_phase_a(ds, b_pad: int = 256, n_check: int = 64) -> None:
    """Phase A at ``b_pad`` query lanes in its narrow, wide and packed
    layouts.  Maxima must lie within MARGIN_REL * |m| + MARGIN_ABS of
    the oracle's per-slice maxima, with the same empty slices."""
    import jax.numpy as jnp

    from bench import make_query_mix
    from fugu_tpu.ops import batch_scorer as bs

    docs = ds.docs()
    seg, stats = docs.segments[0], docs.stats()
    pack = seg.block_major(stats)
    nb_pad = bs._nb_pad(pack.n_blocks)
    offs = jnp.asarray(bs.pad_sub_offs(pack.sub_offs, nb_pad))
    n_terms_pad = bs.n_terms_bucket(pack.n_terms)
    fine = bs.FINE_PER_BLOCK
    narrow = [p for _c, p, _l in make_query_mix(
        seg, counts={"should": b_pad}, seed_offset=3)]
    boolean = [p for _c, p, _l in make_query_mix(
        seg, counts={"must": b_pad // 4, "mustnot": b_pad // 4,
                     "facet": b_pad // 2}, seed_offset=4)]
    for layout, plans in (("narrow", narrow), ("wide", boolean),
                          ("packed", boolean)):
        kinds = {i: bs._classify(p) for i, p in enumerate(plans)}
        q_idx = list(range(len(plans)))
        wide = layout != "narrow"
        packed = layout == "packed"
        if packed:
            q_idx = bs._pack_order(q_idx, plans, pack.tid_of, b_pad // 2)
            assert q_idx is not None, "mix does not bit-pack"
        terms: dict = {}
        for i in q_idx:
            if i is not None:
                for t in bs._plan_tids(plans[i], pack.tid_of):
                    terms.setdefault(t, len(terms))
        u_pad = next(u for u in bs.U_BUCKETS if len(terms) <= u)
        eff = bs._effective_kinds(plans, kinds, q_idx, wide)
        shifts: dict = {}
        w2, nm, tids = bs.stage_batch_weights(
            plans, eff, q_idx, terms, stats, pack.tid_of, b_pad, wide,
            plans[0].k1, shifts, packed=packed,
        )
        fn = bs._get_phasea(nb_pad, b_pad, wide, packed, fine, n_terms_pad)
        args = (offs, pack.d_doc, pack.d_tid, pack.d_con,
                jnp.asarray(w2, dtype=jnp.bfloat16), jnp.asarray(tids),
                jnp.asarray(nm))
        compiled, compile_s = _compile(fn, args)
        amax, run_s = _run_s(compiled, args)
        amax = np.asarray(amax)
        worst = 0.0
        checked = 0
        for qi, i in enumerate(q_idx):
            if i is None or checked >= n_check:
                continue
            checked += 1
            got = amax[:, :, qi].reshape(-1)[: nb_pad * fine]
            got = np.where(np.isfinite(got), got + shifts.get(i, 0.0), got)
            want = _oracle_slice_max(seg, plans[i], stats,
                                     bs.BM_FINE_DOCS, nb_pad * fine)
            fin = np.isfinite(want)
            assert np.array_equal(np.isfinite(got), fin), (layout, i)
            err = np.abs(got[fin] - want[fin])
            tol = np.abs(want[fin]) * bs.MARGIN_REL + bs.MARGIN_ABS
            assert np.all(err <= tol), (layout, i, float(err.max()))
            if fin.any():
                worst = max(worst, float((err / tol).max()))
        emit(
            f"kernel:phase_a_{layout}",
            nb_pad=nb_pad, u_pad=u_pad, b_pad=b_pad,
            fine=fine, compile_s=compile_s, run_s=run_s,
            memory=_memory(compiled), checked_queries=checked,
            worst_err_over_margin=round(worst, 4),
        )


def check_block_scorer(ds, n_plans: int = 8) -> None:
    """The block scorer at 256-block rows and k=128 (limit 128: every
    nonempty block of each query, no slack): ids, order and f32 scores
    equal the oracle's."""
    import jax
    import jax.numpy as jnp

    from bench import make_query_mix
    from fugu_tpu.ops import buckets, oracle
    from fugu_tpu.ops import pallas_scorer as ps

    docs = ds.docs()
    seg, stats = docs.segments[0], docs.stats()
    plans = [p for _c, p, _l in make_query_mix(
        seg, counts={"should": n_plans}, seed_offset=5)]
    # the widest signature: one row per NB_SPLIT blocks of a query
    nb_pad, t_pad, k = ps.NB_BUCKETS[-1], 4, ps.MAX_K
    cap = max(1, ps.DENSE_ELEMS // (nb_pad * t_pad * ps.BLOCK))
    b_pad = max(x for x in buckets.B_BUCKETS if x <= cap)
    e_doc, e_tffid, _ = seg.device_pack()
    tomb = seg.device_tomb_flags()
    i32 = jnp.int32
    f32 = jnp.float32
    sd = jax.ShapeDtypeStruct
    shapes = (
        sd((b_pad,), i32), sd((b_pad, nb_pad), i32),
        sd((b_pad, nb_pad * t_pad), i32), sd((b_pad, nb_pad * t_pad), i32),
        sd((b_pad, t_pad), f32), sd((b_pad, t_pad), f32),
        sd((b_pad, t_pad), f32), sd((b_pad, t_pad), i32),
        sd((b_pad, 3), i32), e_doc, e_tffid, tomb,
    )
    compiled, compile_s = _compile(
        ps._get_scorer(t_pad, nb_pad, k, b_pad, False), shapes
    )
    ps.pallas_search_batch(seg, plans, stats, k)  # compiles its signatures
    t0 = time.perf_counter()
    got = ps.pallas_search_batch(seg, plans, stats, k)
    run_s = round(time.perf_counter() - t0, 6)
    for p, g in zip(plans, got):
        want = [(np.float32(h.score), h.doc)
                for h in oracle.search([seg], p, k, stats)]
        assert g is not None and [(np.float32(s), d) for s, d in g] == want
    emit(
        "kernel:block_scorer",
        nb_pad=nb_pad, k=k, t_pad=t_pad, b_pad=b_pad,
        compile_s=compile_s, search_s=run_s, memory=_memory(compiled),
        checked_queries=len(plans),
    )


def check_phrase_sweep(ds, corpus: Corpus, b_pad: int = 256,
                       n_check: int = 32) -> None:
    """The phrase sweep at ``b_pad`` phrases, slop 0 and slop 2: per
    fine slice, the maxima match the oracle's phrase scores (f32, one
    rounding apart at most) and the argmax (tf << 8 | 255 - fid) class
    matches exactly."""
    import jax.numpy as jnp

    from fugu_tpu.ops import phrase_stream as pst
    from fugu_tpu.ops.oracle import phrase_postings
    from fugu_tpu.query import PhraseClause, bm25_weight, fieldnorm_cache

    docs = ds.docs()
    seg, stats = docs.segments[0], docs.stats()
    pack = pst.get_token_stream(seg, "text", stats)
    rng = np.random.default_rng(SEED + 11)
    cache = fieldnorm_cache(stats.avg_fieldnorm("text"))
    fids = seg.fieldnorm_ids["text"]
    nb2 = pack.nb_pad * pst.FINE_PER_BLOCK
    for smax, gap in ((0, 1), (pst.MAX_SLOP, 2)):
        clauses = {
            i: PhraseClause("text", pair, slop=smax)
            for i, pair in enumerate(corpus.adjacent(rng, b_pad, gap))
        }
        q_idx = list(clauses)
        want_t, wp, slop, bp, kmax = pst.stage_group_weights(
            pack.tid_of, q_idx, clauses, stats, smax
        )
        fn = pst._get_kernel(pack.nb_pad, bp, kmax, smax)
        args = (jnp.asarray(pack.chunk_offs), pack.d_tok, pack.d_cv,
                pack.d_fid, jnp.asarray(want_t), jnp.asarray(wp),
                jnp.asarray(slop))
        compiled, compile_s = _compile(fn, args)
        out, run_s = _run_s(compiled, args)
        amax, acls = (np.asarray(a) for a in out)
        for qi in q_idx[:n_check]:
            pc = clauses[qi]
            pdocs, ptf = phrase_postings(seg, pc)
            dfs = [stats.doc_freq("text", t) for t in pc.terms]
            w = np.float32(bm25_weight(max(dfs), stats.doc_count, pc.boost))
            tf = ptf.astype(np.float32)
            score = w * (tf / (tf + cache[fids[pdocs].astype(np.int64)]))
            cls = ptf.astype(np.int64) * 256 + (255 - fids[pdocs])
            fine_id = pdocs // pst.BM_FINE_DOCS
            want_max = np.full(nb2, -np.inf, np.float32)
            np.maximum.at(want_max, fine_id, score)
            want_cls = np.full(nb2, -1, np.int64)
            top = score == want_max[fine_id]
            np.maximum.at(want_cls, fine_id[top], cls[top])
            got_max = amax[:, :, qi].reshape(-1)
            got_cls = acls[:, :, qi].reshape(-1)
            fin = np.isfinite(want_max)
            assert np.array_equal(np.isfinite(got_max), fin), (smax, qi)
            np.testing.assert_allclose(got_max[fin], want_max[fin], rtol=1e-6)
            assert np.array_equal(got_cls[fin], want_cls[fin]), (smax, qi)
        emit(
            f"kernel:phrase_sweep_slop{smax}",
            nb_pad=pack.nb_pad, b_pad=bp, kmax=kmax, compile_s=compile_s,
            run_s=run_s, memory=_memory(compiled),
            checked_queries=min(n_check, len(q_idx)),
        )


# -- phase 4 ---------------------------------------------------------------


def make_queries(ds, corpus: Corpus, n: int = 256, seed: int = SEED):
    """[(class, query string, filters, per_page)] over the six classes of
    bench.make_query_mix, as a user would type them."""
    seg = ds.docs().segments[0]
    rng = np.random.default_rng(seed + 1)
    terms = sorted(seg.terms["text"].keys())
    dfs = np.array([seg.terms["text"][t].doc_freq for t in terms], float)
    p = dfs / dfs.sum()

    def pick(k):
        return [terms[j] for j in rng.choice(len(terms), k, replace=False, p=p)]

    share = {"should": 120, "must": 40, "mustnot": 24, "facet": 32,
             "phrase": 24, "per_page_100": 16}
    scale = n / sum(share.values())
    out = []
    for cls, c in share.items():
        for _ in range(max(int(c * scale), 1)):
            filters, per_page = [], 10
            if cls in ("should", "per_page_100"):
                q = " ".join(pick(int(rng.integers(1, 5))))
                per_page = 100 if cls == "per_page_100" else 10
            elif cls == "must":
                q = " ".join("+" + w for w in pick(int(rng.integers(2, 4))))
            elif cls == "mustnot":
                ws = pick(int(rng.integers(2, 4)))
                q = " ".join(ws[:-1]) + " -" + ws[-1]
            elif cls == "facet":
                q = " ".join(pick(int(rng.integers(1, 4))))
                filters = [f"/source/{int(rng.integers(0, 20))}"]
            else:
                a, b = corpus.adjacent(rng, 1)[0]
                q = f'"{a} {b}"'
            out.append((cls, q, filters, per_page))
    phrases = [i for i, x in enumerate(out) if x[0] == "phrase"]
    for i, slop in zip(phrases[-2:], (1, 2)):
        cls, q, f, pp = out[i]
        out[i] = (cls, f"{q}~{slop}", f, pp)
    return out


@contextlib.contextmanager
def _env(**values):
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@contextlib.contextmanager
def _engine_counts():
    """Count the queries each device engine answered, by wrapping the
    module functions the engine looks up at call time."""
    from fugu_tpu.ops import batch_scorer as bs
    from fugu_tpu.ops import pallas_scorer as ps
    from fugu_tpu.ops import phrase_stream as pst

    counts = {"phase_a": 0, "block_scorer": 0, "phrase_sweep": 0}
    orig = (bs.batch_search, ps.pallas_search_collect, pst.phrase_stream_begin)

    def batch_search(*a, **kw):
        out = orig[0](*a, **kw)
        counts["phase_a"] += sum(r is not None for r in out)
        return out

    def collect(handles):
        out = orig[1](handles)
        counts["block_scorer"] += sum(
            r is not None for res in out for r in res
        )
        return out

    def phrase_begin(*a, **kw):
        out = orig[2](*a, **kw)
        counts["phrase_sweep"] += len(out[1])
        return out

    bs.batch_search = batch_search
    ps.pallas_search_collect = collect
    pst.phrase_stream_begin = phrase_begin
    try:
        yield counts
    finally:
        bs.batch_search, ps.pallas_search_collect, pst.phrase_stream_begin = orig


def run_queries(ds, data_dir: Path, corpus: Corpus, n: int = 256) -> None:
    """Phase 4."""
    from fugu_tpu.engine.dataset import Dataset
    from fugu_tpu.server.batcher import SearchBatcher

    queries = make_queries(ds, corpus, n)
    singles = [x for x in queries if x[0] == "should"][:8]

    async def drive(batcher):
        t0 = time.perf_counter()
        batch = await asyncio.gather(*(
            batcher.search(ds, q, f, 0, pp) for _c, q, f, pp in queries
        ))
        t1 = time.perf_counter()
        ones = [await batcher.search(ds, q, f, 0, pp)
                for _c, q, f, pp in singles]
        return batch, ones, t1 - t0, time.perf_counter() - t1

    # FUGU_ENGINE=pallas is the auto choice at this size already; the
    # phrase router's cost model was fitted on other hardware and could
    # keep every phrase on the host, so the sweep is forced on
    with _env(FUGU_PHRASE_STREAM="1", FUGU_ENGINE="pallas"), \
            _engine_counts() as counts:
        batch, ones, t_batch, t_singles = asyncio.run(drive(SearchBatcher()))
        _b2, _o2, t_batch2, t_singles2 = asyncio.run(drive(SearchBatcher()))

    host = Dataset(NAMESPACE, data_dir, use_device=False)
    try:
        mismatches = []
        for (cls, q, f, pp), got in zip(queries + singles, batch + ones):
            want = host.search_many([(q, f)], 0, pp)[0]
            if [(r.id, np.float32(r.score)) for r in got] != [
                (r.id, np.float32(r.score)) for r in want
            ]:
                mismatches.append((cls, q))
    finally:
        host.close()
    assert not mismatches, f"device != host on {len(mismatches)}: {mismatches[:5]}"
    assert all(v >= 1 for v in counts.values()), counts
    emit(
        "queries",
        batch_queries=len(queries),
        single_queries=len(singles),
        classes={c: sum(1 for x in queries if x[0] == c)
                 for c in dict.fromkeys(x[0] for x in queries)},
        engine_answers=counts,
        batch_wall_s_first=round(t_batch, 3),
        batch_wall_s_second=round(t_batch2, 3),
        singles_wall_s_first=round(t_singles, 3),
        singles_wall_s_second=round(t_singles2, 3),
        peak_bytes_in_use=_peak_bytes(),
        note="smoke readings, not benchmark results",
    )


def run(n_docs: int, b_pad: int = 256) -> None:
    """Phases 2-4 at ``n_docs`` documents."""
    with tempfile.TemporaryDirectory(prefix="fugu_smoke_") as tmp:
        mgr, ds, corpus = load_store(n_docs, Path(tmp))
        try:
            check_phase_a(ds, b_pad=b_pad)
            check_block_scorer(ds)
            check_phrase_sweep(ds, corpus, b_pad=b_pad)
            run_queries(ds, Path(tmp), corpus)
        finally:
            mgr.close()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--docs", type=int, default=1_000_000)
    args = ap.parse_args()
    dev = device_check()
    run(args.docs)
    import jax

    print(json.dumps({
        "ok": True,
        "device": {
            "platform": dev.platform,
            "kind": dev.device_kind,
            "count": len(jax.devices()),
        },
    }))


if __name__ == "__main__":
    main()
