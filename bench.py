"""Benchmark: BM25 top-k QPS on the device pipeline vs host baselines.

Prints ONE JSON line:
    {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...}

Workload: a 256-query mix of pure-SHOULD disjunctions, MUST
intersections, MUST_NOT exclusions, facet-filtered queries, phrase
queries, and limit=100 queries.

Baselines: the reference publishes no numbers, so the denominator is
the strongest host stand-in on the same machine: the **block-max pruned
scalar scorer** (ops/blockmax.py) — index-time skip tables + WAND-style
bound pruning, i.e. what Tantivy does per query — with the naive
full-traversal oracle also reported.  `vs_baseline` = device QPS / the
stronger of the two host baselines on the same mix, same run.  The
corpus is synthetic Zipfian text shaped like MS MARCO passages
(~55 tokens/doc; the data set itself is not available offline).

Recall parity runs on ALL queries; exact-order agreement and
tie-tolerant agreement (equal f32 score multisets) are reported
separately.  The JSON line names the device (JAX platform, kind and
count, and nvidia-smi's name and power limit on a GPU).

Progress goes to stderr; stdout carries exactly the one JSON line.
FUGU_PROFILE_DIR=<dir> wraps the timed run in a jax.profiler trace.
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).parent))

N_DOCS = int(os.environ.get("BENCH_DOCS", 1_000_000))
N_QUERIES = int(os.environ.get("BENCH_QUERIES", 256))
VOCAB_SIZE = 30_000
MEAN_DOC_LEN = 55
SEED = 7

CACHE = Path(__file__).parent / ".bench_cache"


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def ingest_microbench() -> float:
    """Bounded probe of the FULL engine ingest path — ObjectRecord
    validation -> per-index doc building (docs + filter_index +
    query_index, facet expansion, suggestions) -> 3 synchronous commits
    per batch — i.e. what `POST /ingest` costs.  BENCH_INGEST_DOCS
    (default 10k) synthetic ~55-token docs in 4 batches on a temp dir.
    (The raw SegmentBuilder doc-build loop is much faster than this
    end-to-end number — don't compare the two.)"""
    import shutil
    import tempfile

    from fugu_tpu.engine.manager import DatasetManager
    from fugu_tpu.records import ObjectRecord

    n = int(os.environ.get("BENCH_INGEST_DOCS", "10000"))
    rng = np.random.default_rng(3)
    vocab = np.array([f"t{i:05d}" for i in range(VOCAB_SIZE)])
    p = 1.0 / np.arange(1, VOCAB_SIZE + 1) ** 1.07
    p /= p.sum()
    lens = np.clip(rng.poisson(MEAN_DOC_LEN, n), 5, 200)
    starts = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lens, out=starts[1:])
    all_words = vocab[rng.choice(VOCAB_SIZE, size=int(starts[-1]), p=p)]
    recs = [
        ObjectRecord(
            id=f"d{i}",
            text=" ".join(all_words[starts[i] : starts[i + 1]]),
            metadata={"source": str(int(i % 20))},
        )
        for i in range(n)
    ]
    tmp = tempfile.mkdtemp(prefix="fugu_ingest_bench_")
    try:
        mgr = DatasetManager.with_defaults(tmp, "bench")
        ds = mgr.get_or_create_dataset("bench")
        t0 = time.perf_counter()
        step = max(n // 4, 1)
        for lo in range(0, n, step):
            ds.ingest(recs[lo : lo + step])
        dt = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return round(n / dt, 1)


def msmarco_tokens(n_docs: int, seed: int = SEED):
    """(words, starts, sources) for ``n_docs`` MS MARCO-shaped passages:
    Zipf(1.07) over a VOCAB_SIZE vocabulary, Poisson(MEAN_DOC_LEN)
    tokens per doc clipped to [5, 200], one of 20 sources per doc.  Doc
    i's tokens are ``words[starts[i]:starts[i + 1]]``.  Every token is
    drawn in one vectorized pass (a per-doc draw with a 30k-entry p is
    ~1ms/doc — hours at 8M docs)."""
    rng = np.random.default_rng(seed)
    vocab = np.array([f"t{i:05d}" for i in range(VOCAB_SIZE)])
    p = 1.0 / np.arange(1, VOCAB_SIZE + 1) ** 1.07
    p /= p.sum()
    lens = np.clip(rng.poisson(MEAN_DOC_LEN, n_docs), 5, 200)
    starts = np.zeros(n_docs + 1, dtype=np.int64)
    np.cumsum(lens, out=starts[1:])
    words = vocab[rng.choice(VOCAB_SIZE, size=int(starts[-1]), p=p)]
    sources = rng.integers(0, 20, n_docs)
    return words, starts, sources


def build_corpus():
    """Synthetic Zipfian corpus, cached as a frozen segment on disk."""
    from fugu_tpu.index.manifest import load_segment, save_segment
    from fugu_tpu.index.schema import DOCS_SCHEMA
    from fugu_tpu.index.segment import SegmentBuilder

    tag = f"v1-{N_DOCS}"
    seg_id = "bench" + tag.replace("-", "")
    CACHE.mkdir(exist_ok=True)
    marker = CACHE / f"seg-{seg_id}.npz"
    if marker.exists():
        log(f"loading cached corpus {marker}")
        return load_segment(CACHE, seg_id, DOCS_SCHEMA)

    log(f"building corpus: {N_DOCS} docs, vocab {VOCAB_SIZE}")
    b = SegmentBuilder(DOCS_SCHEMA)
    t0 = time.time()
    all_words, starts, srcs = msmarco_tokens(N_DOCS)
    for i in range(N_DOCS):
        b.add_document(
            {"text": [" ".join(all_words[starts[i] : starts[i + 1]])]},
            facets=[f"/source/{int(srcs[i])}"],
            stored={"id": f"d{i}"},
        )
        if i % 200000 == 199999:
            log(f"  {i + 1} docs ({time.time() - t0:.0f}s)")
    seg = b.build()
    seg.segment_id = seg_id
    save_segment(seg, CACHE)
    log(f"corpus built in {time.time() - t0:.0f}s: {seg.n_entries} postings")
    return seg


def make_query_mix(seg, counts=None, seed_offset=1):
    """The 256-query mixed workload: [(class, plan, limit)].

    With `counts` given (e.g. {"must": 256}) the exact per-class counts
    are generated unscaled — used for the full-batch per-class timing,
    where each class is measured at the SAME batch size as the mixed
    headline instead of its small share of the mix.
    """
    from fugu_tpu.query import Occur, PhraseClause, QueryGroup, QueryPlan, TermClause

    rng = np.random.default_rng(SEED + seed_offset)
    terms = sorted(seg.terms["text"].keys())
    dfs = np.array([seg.terms["text"][t].doc_freq for t in terms], dtype=np.float64)
    w = dfs / dfs.sum()

    def pick(n):
        idx = rng.choice(len(terms), size=n, replace=False, p=w)
        return [terms[i] for i in idx]

    def should_plan(words):
        return QueryPlan(
            groups=tuple(
                QueryGroup(Occur.SHOULD, (TermClause("text", t),)) for t in words
            )
        )

    explicit = counts is not None
    if counts is None:
        counts = {
            "should": 120,
            "must": 40,
            "mustnot": 24,
            "facet": 32,
            "phrase": 24,
            "limit100": 16,
        }
    scale = 1.0 if explicit else N_QUERIES / sum(counts.values())

    def n_of(cls):
        n = int(counts.get(cls, 0) * scale)
        return n if explicit else max(n, 1)

    mix = []
    for _ in range(n_of("should")):
        mix.append(("should", should_plan(pick(int(rng.integers(1, 5)))), 10))
    for _ in range(n_of("must")):
        words = pick(int(rng.integers(2, 4)))
        mix.append(
            (
                "must",
                QueryPlan(
                    groups=tuple(
                        QueryGroup(Occur.MUST, (TermClause("text", t),))
                        for t in words
                    )
                ),
                10,
            )
        )
    for _ in range(n_of("mustnot")):
        words = pick(int(rng.integers(2, 4)))
        groups = [
            QueryGroup(Occur.SHOULD, (TermClause("text", t),)) for t in words[:-1]
        ] + [QueryGroup(Occur.MUST_NOT, (TermClause("text", words[-1]),))]
        mix.append(("mustnot", QueryPlan(groups=tuple(groups)), 10))
    for _ in range(n_of("facet")):
        words = pick(int(rng.integers(1, 4)))
        groups = [
            QueryGroup(Occur.SHOULD, (TermClause("text", t),)) for t in words
        ] + [
            QueryGroup(
                Occur.MUST,
                (
                    TermClause(
                        "", f"/source/{int(rng.integers(0, 20))}", is_facet=True
                    ),
                ),
            )
        ]
        mix.append(("facet", QueryPlan(groups=tuple(groups)), 10))
    for _ in range(n_of("phrase")):
        words = pick(2)
        mix.append(
            (
                "phrase",
                QueryPlan(
                    groups=(
                        QueryGroup(
                            Occur.SHOULD,
                            phrases=(PhraseClause("text", tuple(words)),),
                        ),
                    )
                ),
                10,
            )
        )
    for _ in range(n_of("limit100")):
        mix.append(("limit100", should_plan(pick(int(rng.integers(1, 5)))), 100))
    return mix if explicit else mix[:N_QUERIES]


def device_run(seg, stats, mix):
    """Run the whole mix through the production engine stack: two-phase
    batch engine (all limits share the phase-A corpus streams) -> Pallas
    block scorer -> host.

    Host-only plans (phrases) run on a worker thread CONCURRENTLY with
    the device waves — their NumPy work hides under the device waits
    (both release the GIL), exactly as a production server overlaps
    them — so phrase latency mostly vanishes from the mixed wall time.
    """
    import threading

    from fugu_tpu.ops import oracle
    from fugu_tpu.ops.batch_scorer import batch_search
    from fugu_tpu.ops.blockmax import search_blockmax
    from fugu_tpu.ops.pallas_scorer import (
        pallas_search_begin,
        pallas_search_collect,
    )

    plans = [m[1] for m in mix]
    lims = [m[2] for m in mix]
    results = [None] * len(mix)

    def host_path(i):
        r = search_blockmax(seg, plans[i], stats, lims[i])
        if r is None:
            r = [
                (h.score, h.doc)
                for h in oracle.search([seg], plans[i], lims[i], stats)
            ]
        return r

    host_is = [i for i, p in enumerate(plans) if p.host_only]
    all_host = list(host_is)
    # phrase sweep (FUGU_PHRASE_STREAM=auto default: the cost model
    # routes each batch — see engine/named_index.py's routing comment) —
    # one corpus-position sweep serves the whole phrase batch;
    # ops/phrase_stream.  The gather-based device phrase path stays
    # opt-in via FUGU_DEVICE_PHRASE=1.
    from fugu_tpu.ops.phrase_stream import (
        estimate_device_batch_ms,
        want_stream,
    )

    n_dev = sum(1 for p in plans if not p.host_only)
    phrase_handle = None
    stream_handle = None
    if host_is and want_stream(
        len(host_is),
        plans=[plans[i] for i in host_is],
        stats=stats,
        # host phrases overlap the device batch's wait for free (worker
        # thread below); only their excess competes with the stream
        overlap_ms=estimate_device_batch_ms(stats, n_dev),
    ):
        from fugu_tpu.ops.phrase_stream import (
            phrase_stream_begin,
            phrase_stream_collect,
        )

        stream_handle = phrase_stream_begin(
            seg,
            [plans[i] for i in host_is],
            stats,
            [lims[i] for i in host_is],
        )
        pre, staged = stream_handle[0], stream_handle[1]
        covered = {qi for qi, _ in staged} | {
            j for j, r in enumerate(pre) if r is not None
        }
        host_is = [i for j, i in enumerate(host_is) if j not in covered]
    if host_is and stream_handle is None and os.environ.get(
        "FUGU_DEVICE_PHRASE"
    ) == "1":
        from fugu_tpu.ops.device_phrase import (
            device_phrase_begin,
            device_phrase_collect,
        )

        phrase_handle = device_phrase_begin(
            seg, [plans[i] for i in host_is], stats, max(lims[i] for i in host_is)
        )
        pre, staged = phrase_handle[0], phrase_handle[1]
        covered = {qi for qi, _ in staged} | {
            j for j, r in enumerate(pre) if r is not None
        }
        host_is = [i for j, i in enumerate(host_is) if j not in covered]
    th = None
    if host_is:
        def host_work():
            for i in host_is:
                results[i] = host_path(i)
        th = threading.Thread(target=host_work)
        th.start()

    dev_is = [i for i, p in enumerate(plans) if not p.host_only]
    sub = batch_search(
        seg, [plans[i] for i in dev_is], stats, [lims[i] for i in dev_is]
    )
    by_limit = {}
    for j, r in enumerate(sub):
        i = dev_is[j]
        results[i] = r
        if r is None:
            by_limit.setdefault(lims[i], []).append(i)
    groups = list(by_limit.items())
    handles = [
        pallas_search_begin(seg, [plans[i] for i in idxs], stats, limit)
        for limit, idxs in groups
    ]
    for (limit, idxs), fill in zip(groups, pallas_search_collect(handles)):
        for i, r in zip(idxs, fill):
            results[i] = r
    if stream_handle is not None:
        # phrase_stream_collect imported where stream_handle was set
        stream_res = phrase_stream_collect(stream_handle)
        for j, i in enumerate(all_host):
            if stream_res[j] is not None:
                results[i] = stream_res[j]
    if phrase_handle is not None:
        # device_phrase_collect already imported where phrase_handle was set
        phrase_res = device_phrase_collect(phrase_handle)
        for j, i in enumerate(all_host):
            if phrase_res[j] is not None and results[i] is None:
                results[i] = phrase_res[j][: lims[i]]
    if th is not None:
        th.join()
    for i, r in enumerate(results):
        if r is None:  # device-declined plans: host fallback
            results[i] = host_path(i)
    return results


def device_info() -> dict:
    """The device this run measures: JAX's platform, kind and count,
    plus nvidia-smi's name and power limit on a GPU."""
    import subprocess

    import jax

    devs = jax.devices()
    info = {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }
    if info["platform"] == "gpu":
        info["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip()
    return info


def main() -> None:
    t_start = time.time()
    device = device_info()
    log(f"device: {device}")
    seg = build_corpus()
    from fugu_tpu.ops import oracle

    stats = oracle.IndexStats([seg])
    mix = make_query_mix(seg)
    classes = sorted({c for c, _, _ in mix})
    log(f"query mix: {len(mix)} queries " + str({c: sum(1 for x in mix if x[0] == c) for c in classes}))

    log("warmup/compile (all engines, all signatures)...")
    t0 = time.time()
    device_run(seg, stats, mix)
    log(f"warmup done in {time.time() - t0:.1f}s")

    # converge the warmup: keep warming until two consecutive passes
    # agree within 10% (bounded retries), so the TIMED passes measure
    # the engine, not first-use effects
    prev = None
    for attempt in range(6):
        t0 = time.time()
        device_run(seg, stats, mix)
        dt = time.time() - t0
        log(f"  warm pass {attempt}: {len(mix) / dt:.1f} QPS")
        if prev is not None and abs(dt - prev) <= 0.10 * max(dt, prev):
            break
        prev = dt

    profile_dir = os.environ.get("FUGU_PROFILE_DIR")
    if profile_dir:
        import jax

        jax.profiler.start_trace(profile_dir)

    # median of 5 timed passes; the per-pass spread ships in the JSON
    # line so a noisy run is visible as such
    times = []
    device_hits = None
    n_passes = int(os.environ.get("BENCH_PASSES", "5"))
    for rep in range(n_passes):
        t0 = time.time()
        device_hits = device_run(seg, stats, mix)
        times.append(time.time() - t0)
        log(f"  pass {rep}: {len(mix) / times[-1]:.1f} QPS")
    device_s = sorted(times)[len(times) // 2]
    pass_qps = [round(len(mix) / t, 1) for t in times]
    qps = len(mix) / device_s
    log(
        f"device mixed-workload: {qps:.1f} QPS (median of 3), "
        f"{device_s / len(mix) * 1000:.2f} ms/query amortized"
    )
    if profile_dir:
        import jax

        jax.profiler.stop_trace()
        log(f"profile trace written to {profile_dir}")

    # per-class QPS (each class timed as its own batch; one untimed pass
    # first — per-class batch shapes differ from the mixed run's and the
    # first use of a persistently-cached executable pays a ~1s load)
    for cls in classes:
        idxs = [i for i, (c, _, _) in enumerate(mix) if c == cls]
        sub = [mix[i] for i in idxs]
        device_run(seg, stats, sub)
        t0 = time.time()
        device_run(seg, stats, sub)
        dt = time.time() - t0
        log(f"  class {cls:9s}: {len(sub)/dt:8.1f} QPS ({len(sub)} queries)")

    # per-class QPS at FULL batch size: each class's share of the mix is
    # 16-120 queries, where one stream's fixed cost floors the isolated
    # number.  Timing each class as its own N_QUERIES-sized batch is the
    # apples-to-apples class throughput (same amortization as the mixed
    # headline). Skippable for quick runs with BENCH_CLASS_FULL=0.
    class_full_qps = {}
    if os.environ.get("BENCH_CLASS_FULL", "1") != "0":
        for cls in classes:
            full = make_query_mix(seg, counts={cls: N_QUERIES}, seed_offset=2)
            device_run(seg, stats, full)  # warm this batch's signatures
            t0 = time.time()
            device_run(seg, stats, full)
            dt = time.time() - t0
            class_full_qps[cls] = round(len(full) / dt, 1)
            log(
                f"  class {cls:9s} @ full batch: {len(full)/dt:8.1f} QPS "
                f"({len(full)} queries)"
            )

    # single-stream latency through the production single-query path
    from fugu_tpu.ops.pallas_scorer import pallas_search_batch

    lat_samples = []
    singles = [m for m in mix if m[0] == "should"][:40]
    for _cls, plan, limit in singles:
        t1 = time.time()
        r = pallas_search_batch(seg, [plan], stats, limit)[0]
        assert r is not None
        lat_samples.append((time.time() - t1) * 1000)
    lat_samples.sort()
    p50 = lat_samples[len(lat_samples) // 2]
    p99 = lat_samples[min(int(len(lat_samples) * 0.99), len(lat_samples) - 1)]
    log(f"single-stream latency (block scorer): p50={p50:.2f}ms p99={p99:.2f}ms")

    # pipelining the same singles (begin all, collect once) overlaps
    # their host staging and device work
    from fugu_tpu.ops.pallas_scorer import (
        pallas_search_begin,
        pallas_search_collect,
    )

    t0 = time.time()
    handles = [
        pallas_search_begin(seg, [plan], stats, limit)
        for _cls, plan, limit in singles
    ]
    outs = pallas_search_collect(handles)
    assert all(o[0] is not None for o in outs)
    pipe_ms = (time.time() - t0) / len(singles) * 1000
    log(
        f"pipelined singles: {pipe_ms:.2f} ms/query"
    )

    # --- host baselines -----------------------------------------------------
    from fugu_tpu.ops.blockmax import search_blockmax

    def host_run(sub):
        out = []
        for _cls, plan, limit in sub:
            r = search_blockmax(seg, plan, stats, limit)
            if r is None:
                r = [
                    (h.score, h.doc)
                    for h in oracle.search([seg], plan, limit, stats)
                ]
            out.append(r)
        return out

    host_run(mix[:8])  # warm skip tables
    host_times = []
    baseline_hits = None
    for _rep in range(3):  # median of 3: same courtesy as the device
        t0 = time.time()
        baseline_hits = host_run(mix)
        host_times.append(time.time() - t0)
    blockmax_s = sorted(host_times)[1]
    blockmax_qps = len(mix) / blockmax_s
    baseline_passes_qps = [round(len(mix) / t, 1) for t in host_times]
    log(f"baseline (block-max host, same mix): {blockmax_qps:.1f} QPS (median of 3)")

    n_naive = min(32, len(mix))
    # EVENLY-SPACED sample: the mix is built class-by-class (shoulds
    # first), so mix[:32] would time only pure-SHOULD queries and skip
    # the oracle's expensive classes (phrases!), inflating the baseline
    naive_sample = [
        mix[round(i * (len(mix) - 1) / max(n_naive - 1, 1))]
        for i in range(n_naive)
    ]
    t0 = time.time()
    for _cls, plan, limit in naive_sample:
        oracle.search([seg], plan, limit, stats)
    naive_qps = len(naive_sample) / (time.time() - t0)
    log(f"baseline (naive full-traversal oracle): {naive_qps:.1f} QPS (from {n_naive})")
    # the denominator is the STRONGER host baseline (naive wins on small
    # corpora where block bookkeeping dominates; block-max wins at scale)
    base_qps = max(blockmax_qps, naive_qps)

    # --- recall parity on ALL queries ---------------------------------------
    exact = tie_ok = 0
    for (cls, plan, limit), hits, base in zip(mix, device_hits, baseline_hits):
        got = [(np.float32(s), d) for s, d in (hits or [])]
        want = [(np.float32(s), d) for s, d in (base or [])]
        if got == want:
            exact += 1
            tie_ok += 1
            continue
        gs = np.array([s for s, _ in got], dtype=np.float64)
        ws = np.array([s for s, _ in want], dtype=np.float64)
        if len(gs) == len(ws) and np.allclose(gs, ws, rtol=1e-5):
            tie_ok += 1
            diffs = [
                (i, g, w)
                for i, (g, w) in enumerate(zip(got, want))
                if g != w
            ]
            log(f"  TIE-ONLY [{cls}] {len(diffs)} slots differ: {diffs[:4]}")
        else:
            log(f"  PARITY FAIL [{cls}] got={got[:3]} want={want[:3]}")
    log(
        f"recall parity ({len(mix)} queries): exact-order {exact}/{len(mix)}, "
        f"tie-tolerant {tie_ok}/{len(mix)}"
    )

    ingest_rate = ingest_microbench()
    log(f"ingest {ingest_rate} docs/s")

    log(f"total bench time {time.time() - t_start:.0f}s")
    print(
        json.dumps(
            {
                "metric": f"BM25 mixed-workload QPS ({N_DOCS} docs, batched)",
                "value": round(qps, 2),
                "unit": "queries/s",
                "vs_baseline": round(qps / base_qps, 2),
                "baseline": (
                    "blockmax-host"
                    if blockmax_qps >= naive_qps
                    else "naive-oracle-host"
                ),
                "exact_order": f"{exact}/{len(mix)}",
                "tie_tolerant": f"{tie_ok}/{len(mix)}",
                "passes_qps": pass_qps,
                "per_class_full_qps": class_full_qps,
                "baseline_passes_qps": baseline_passes_qps,
                "ingest_docs_per_s": ingest_rate,
                "device": device,
            }
        )
    )


if __name__ == "__main__":
    main()
