"""Parity tests for the phrase stream engine (ops/phrase_stream.py)
against the exact oracle matcher.

Runs the Triton kernel in interpret mode on the CPU backend (conftest);
the same kernel compiles for the GPU.  Every result must be
bit-identical to oracle.search — phase B host-rescores survivors with
the exact float sequence, so no ulp tolerance is needed.
"""

import numpy as np
import pytest

from fugu_tpu.index.schema import DOCS_SCHEMA
from fugu_tpu.index.segment import SegmentBuilder
from fugu_tpu.ops import oracle
from fugu_tpu.ops.phrase_stream import (
    batch_phrase_search,
    eligible_phrase,
    get_token_stream,
)
from fugu_tpu.query import (
    Occur,
    PhraseClause,
    QueryGroup,
    QueryPlan,
    TermClause,
)


def _phrase_plan(words, occur=Occur.SHOULD, slop=0, boost=1.0):
    return QueryPlan(
        groups=(
            QueryGroup(
                occur,
                phrases=(
                    PhraseClause("text", tuple(words), slop=slop, boost=boost),
                ),
            ),
        )
    )


def _expect(seg, stats, plan, limit):
    return [
        (np.float32(h.score), h.doc)
        for h in oracle.search([seg], plan, limit, stats)
    ]


def _got(res):
    return [(np.float32(s), d) for s, d in res]


@pytest.fixture(scope="module")
def seg():
    rng = np.random.default_rng(5)
    words = [f"w{i}" for i in range(30)]
    b = SegmentBuilder(DOCS_SCHEMA)
    for i in range(2600):  # > 4 blocks of 512 docs
        n = int(rng.integers(4, 30))
        text = " ".join(rng.choice(words, size=n))
        vals = [text]
        if i % 7 == 0:
            # multi-value field: adjacency must not cross the gap
            vals = [text, " ".join(rng.choice(words, size=5))]
        b.add_document({"text": vals}, stored={"id": f"d{i}"})
    # one LONG doc spanning multiple 2048-row chunks (overlap path)
    b.add_document(
        {"text": [" ".join(["w1 w2"] * 1500 + ["w3 w4 w5 w6 w7 w8 w9 w10"])]},
        stored={"id": "long"},
    )
    s = b.build()
    s.tombstones[::37] = True
    return s


@pytest.fixture(scope="module")
def stats(seg):
    return oracle.IndexStats([seg])


def test_two_term_parity(seg, stats):
    rng = np.random.default_rng(3)
    plans, limits = [], []
    for _ in range(24):
        w = rng.integers(0, 30, size=2)
        plans.append(_phrase_plan([f"w{w[0]}", f"w{w[1]}"]))
        limits.append(10)
    res = batch_phrase_search(seg, plans, stats, limits, min_batch=1)
    served = 0
    for plan, lim, got in zip(plans, limits, res):
        assert got is not None
        served += 1
        assert _got(got) == _expect(seg, stats, plan, lim), plan
    assert served == len(plans)


def test_variable_lengths_and_limits(seg, stats):
    plans = [
        _phrase_plan(["w1"]),                      # single term
        _phrase_plan(["w1", "w2", "w1"]),          # repeated term slots
        _phrase_plan(["w3", "w4", "w5", "w6"]),
        _phrase_plan(["w3", "w4", "w5", "w6", "w7", "w8", "w9", "w10"]),
        _phrase_plan(["w0", "zzz-absent"]),        # absent term -> []
        _phrase_plan(["w2", "w0"], occur=Occur.MUST),
        _phrase_plan(["w5", "w9"], boost=2.5),
    ]
    limits = [5, 10, 10, 10, 10, 100, 7]
    res = batch_phrase_search(seg, plans, stats, limits, min_batch=1)
    for plan, lim, got in zip(plans, limits, res):
        assert got is not None
        assert _got(got) == _expect(seg, stats, plan, lim), plan
    assert res[4] == []


def test_long_doc_chunk_overlap(seg, stats):
    # the 1500x "w1 w2" doc: adjacency pairs straddle chunk boundaries;
    # phrase_tf must match the oracle exactly (anchors counted once)
    plan = _phrase_plan(["w1", "w2"])
    res = batch_phrase_search(seg, [plan], stats, [3], min_batch=1)
    assert _got(res[0]) == _expect(seg, stats, plan, 3)
    # the long doc dominates on tf; it must be the top hit
    assert res[0][0][1] == seg.doc_count - 1


def test_tombstones_drop_out(seg, stats):
    # doc 0 is tombstoned (::37); no result may contain a dead doc
    plans = [_phrase_plan([f"w{i}", f"w{(i + 1) % 30}"]) for i in range(12)]
    res = batch_phrase_search(seg, plans, stats, [50] * 12, min_batch=1)
    dead = set(np.nonzero(seg.tombstones)[0].tolist())
    for plan, got in zip(plans, res):
        assert got is not None
        assert not ({d for _s, d in got} & dead)
        assert _got(got) == _expect(seg, stats, plan, 50), plan


def test_ineligible_plans_fall_through(seg, stats):
    deep_slop = _phrase_plan(["w1", "w2"], slop=3)  # > MAX_SLOP
    # slop > 0 caps terms at KGAP+1-MAX_SLOP = 7 (roll-wrap constraint)
    wide_slop = _phrase_plan([f"w{i}" for i in range(8)], slop=1)
    multi = QueryPlan(
        groups=(
            QueryGroup(
                Occur.SHOULD, phrases=(PhraseClause("text", ("w1", "w2")),)
            ),
            QueryGroup(Occur.SHOULD, (TermClause("text", "w3"),)),
        )
    )
    nine = _phrase_plan([f"w{i}" for i in range(9)])
    assert eligible_phrase(deep_slop) is None
    assert eligible_phrase(wide_slop) is None
    assert eligible_phrase(multi) is None
    assert eligible_phrase(nine) is None
    res = batch_phrase_search(
        seg,
        [deep_slop, wide_slop, multi, nine],
        stats,
        [10, 10, 10, 10],
        min_batch=1,
    )
    assert res == [None, None, None, None]


def test_slop_parity(seg, stats):
    """r5: slop <= MAX_SLOP runs on the stream kernel (per-slot shift
    windows, clamped) — bit-identical to the oracle's ordered-window
    slop for fuzzed sloppy phrases, mixed slops in one batch."""
    rng = np.random.default_rng(9)
    plans, limits = [], []
    for _ in range(20):
        k = int(rng.integers(2, 5))
        w = rng.integers(0, 30, size=k)
        slop = int(rng.integers(1, 3))  # 1 or 2
        plans.append(_phrase_plan([f"w{x}" for x in w], slop=slop))
        limits.append(int(rng.choice([3, 10, 50])))
    # mixed batch: sloppy + slop-0 in one begin (separate dispatches)
    plans.append(_phrase_plan(["w1", "w2"]))
    limits.append(10)
    res = batch_phrase_search(seg, plans, stats, limits, min_batch=1)
    for plan, lim, got in zip(plans, limits, res):
        assert got is not None, plan
        assert _got(got) == _expect(seg, stats, plan, lim), plan


def test_slop_long_doc_and_bounds(seg, stats):
    """Sloppy adjacency across chunk boundaries + 7-term slop-2 at the
    eligibility edge + sloppy boost."""
    plans = [
        _phrase_plan(["w1", "w3"], slop=1),   # w1 _ w3 via the w2 gap
        _phrase_plan(["w1", "w2"], slop=2),   # superset of exact matches
        _phrase_plan([f"w{i}" for i in range(3, 10)], slop=2),  # 7 terms
        _phrase_plan(["w2", "w5"], slop=2, boost=1.7),
    ]
    limits = [10, 5, 10, 10]
    res = batch_phrase_search(seg, plans, stats, limits, min_batch=1)
    for plan, lim, got in zip(plans, limits, res):
        assert got is not None, plan
        assert _got(got) == _expect(seg, stats, plan, lim), plan


def test_multivalue_gap_blocks_adjacency():
    b = SegmentBuilder(DOCS_SCHEMA)
    b.add_document({"text": ["alpha beta", "gamma delta"]}, stored={})
    b.add_document({"text": ["alpha beta gamma delta"]}, stored={})
    s = b.build()
    st = oracle.IndexStats([s])
    plan = _phrase_plan(["beta", "gamma"])
    res = batch_phrase_search(s, [plan], st, [10], min_batch=1)
    assert _got(res[0]) == _expect(s, st, plan, 10)
    assert [d for _s, d in res[0]] == [1]  # doc 0's gap blocks the match


def test_topk_truncation_with_pervasive_ties():
    """More matching fine blocks than PHRASE_TOPK ships, with IDENTICAL
    (tf, fid) classes everywhere: the clean-tie skip (device top_k keeps
    lowest ids for equal values; later blocks lose the doc-asc
    tie-break) or the full-common fallback must both reproduce the
    oracle exactly."""
    from fugu_tpu.ops.phrase_stream import PHRASE_TOPK

    b = SegmentBuilder(DOCS_SCHEMA)
    need_docs = (PHRASE_TOPK + 8) * 256  # > PHRASE_TOPK fine blocks
    for i in range(need_docs // 16):
        # 16 docs per batch-row keeps the Python loop tolerable; every
        # doc matches "foo bar" with the same length (same class)
        for j in range(16):
            b.add_document(
                {"text": ["foo bar baz qux"]}, stored={"id": f"d{i}_{j}"}
            )
    s = b.build()
    st = oracle.IndexStats([s])
    plan = _phrase_plan(["foo", "bar"])
    for lim in (3, 10):
        res = batch_phrase_search(s, [plan], st, [lim], min_batch=1)
        assert _got(res[0]) == _expect(s, st, plan, lim)


def test_want_stream_auto_routing(monkeypatch):
    from fugu_tpu.ops import phrase_stream as ps

    monkeypatch.delenv("FUGU_PHRASE_STREAM", raising=False)
    assert ps.phrase_stream_mode() == "auto"
    assert not ps.want_stream(ps.PHRASE_AUTO_MIN - 1)
    assert ps.want_stream(ps.PHRASE_AUTO_MIN)
    monkeypatch.setenv("FUGU_PHRASE_STREAM", "0")
    assert not ps.want_stream(10_000)
    monkeypatch.setenv("FUGU_PHRASE_STREAM", "1")
    assert ps.want_stream(1)


class _FakeStats:
    """Minimal stats shim for the routing cost model: 1M docs, 55M
    corpus tokens (the calibration corpus's shape)."""

    doc_count = 1_000_000
    total_tokens = {"text": 55_000_000}

    def __init__(self, dfs):
        self._dfs = dfs

    def doc_freq(self, field, term):
        return self._dfs.get(term, 0)


def test_want_stream_cost_model(monkeypatch):
    """Below PHRASE_AUTO_MIN the router compares calibrated cost models:
    selective phrases stay on the host; Zipf-head pairs (whose host
    intersection cost explodes) go to the stream."""
    from fugu_tpu.ops import phrase_stream as ps

    monkeypatch.delenv("FUGU_PHRASE_STREAM", raising=False)

    def plans_for(pairs):
        return [_phrase_plan(list(p)) for p in pairs]

    selective = _FakeStats({"a": 5_000, "b": 15_000})
    sel_plans = plans_for([("a", "b")] * 8)
    assert not ps.want_stream(8, plans=sel_plans, stats=selective)

    head = _FakeStats({"a": 963_000, "b": 999_000})
    head_plans = plans_for([("a", "b")] * 8)
    assert ps.want_stream(8, plans=head_plans, stats=head)

    # dead phrases (df=0 terms) cost the host nothing — never stream
    dead = _FakeStats({"a": 0, "b": 999_000})
    assert not ps.want_stream(8, plans=plans_for([("a", "b")] * 8), stats=dead)

    # below PHRASE_MIN_BATCH the stream's fixed cost always loses
    assert not ps.want_stream(
        ps.PHRASE_MIN_BATCH - 1,
        plans=head_plans[: ps.PHRASE_MIN_BATCH - 1],
        stats=head,
    )


def test_want_stream_overlap_credit(monkeypatch):
    """With a concurrent device batch, host phrase work hides under the
    device wait (worker thread in named_index) — the router streams only
    when the host estimate EXCEEDS the overlap credit by more than the
    sweep's cost (streaming phrases whose host cost hides under the
    device wait only adds device time)."""
    from fugu_tpu.ops import phrase_stream as ps

    monkeypatch.delenv("FUGU_PHRASE_STREAM", raising=False)

    # moderate head pairs (~23ms host each, the mixed-bench regime):
    # the batch's ~550ms host estimate beats the stream's ~220ms only
    # when no device batch overlaps it
    mid = _FakeStats({"a": 300_000, "b": 300_000})
    plans = [_phrase_plan(["a", "b"])] * 24

    # isolated (no device batch): these stream
    assert ps.want_stream(24, plans=plans, stats=mid)
    # same phrases next to a 232-query device batch: host is free
    ov = ps.estimate_device_batch_ms(mid, 232)
    assert ov > 0
    assert not ps.want_stream(24, plans=plans, stats=mid, overlap_ms=ov)
    # enough of them exceed any overlap budget -> stream again, even
    # above PHRASE_AUTO_MIN (the credit applies at any batch size)
    many = [_phrase_plan(["a", "b"])] * 256
    assert ps.want_stream(256, plans=many, stats=mid, overlap_ms=ov)
    # overlap credit never re-enables a stream the budget refused
    monkeypatch.setenv("FUGU_DEVICE_MEM_BUDGET", "1")
    assert not ps.want_stream(256, plans=many, stats=mid, overlap_ms=ov)
    monkeypatch.delenv("FUGU_DEVICE_MEM_BUDGET", raising=False)
    # explicit modes ignore the credit entirely
    monkeypatch.setenv("FUGU_PHRASE_STREAM", "1")
    assert ps.want_stream(8, plans=plans[:8], stats=mid, overlap_ms=1e9)
    monkeypatch.setenv("FUGU_PHRASE_STREAM", "0")
    assert not ps.want_stream(256, plans=many, stats=mid, overlap_ms=0)


def test_want_stream_respects_residency_budget(monkeypatch):
    """Auto routing refuses to stage a token pack that would blow the
    device budget past what is resident (evicting the phase-A packs
    would cost re-uploads every batch);
    already-resident token bytes count as free; FUGU_PHRASE_STREAM=1
    still forces."""
    from fugu_tpu.ops import phrase_stream as ps
    from fugu_tpu.ops import residency

    monkeypatch.delenv("FUGU_PHRASE_STREAM", raising=False)

    big = _FakeStats({"a": 963_000, "b": 999_000})
    big.doc_count = 16_000_000
    big.total_tokens = {"text": 880_000_000}
    plans = [_phrase_plan(["a", "b"])] * 256

    # unlimited budget: streams (the >=AUTO_MIN branch)
    monkeypatch.setattr(residency, "budget_bytes", lambda: None)
    assert ps.want_stream(256, plans=plans, stats=big)

    # 13.6GB budget with 12.9GB resident: the ~4.5GB token pack cannot
    # fit -> host, even at full batch
    monkeypatch.setattr(residency, "budget_bytes", lambda: 13_600_000_000)
    monkeypatch.setattr(
        residency, "stats",
        lambda: {"resident_bytes": 12_900_000_000, "by_kind": {}},
    )
    assert not ps.want_stream(256, plans=plans, stats=big)

    # same pressure but the token pack is ALREADY resident: streams
    monkeypatch.setattr(
        residency, "stats",
        lambda: {
            "resident_bytes": 12_900_000_000,
            "by_kind": {"token_stream": 6_000_000_000},
        },
    )
    assert ps.want_stream(256, plans=plans, stats=big)

    # forced mode bypasses the guard
    monkeypatch.setattr(
        residency, "stats",
        lambda: {"resident_bytes": 12_900_000_000, "by_kind": {}},
    )
    monkeypatch.setenv("FUGU_PHRASE_STREAM", "1")
    assert ps.want_stream(256, plans=plans, stats=big)


def test_prune_dead_phrases():
    """Parser-expanded multi-field phrases ('"a b"' over text AND name)
    reduce to live alternatives when the extra field's terms have df=0 —
    restoring the single-alternative shape both fast paths require."""
    from fugu_tpu.query import prune_dead_phrases

    df = {("text", "a"): 100, ("text", "b"): 50}

    def df_of(field, term):
        return df.get((field, term), 0)

    two = QueryPlan(
        groups=(
            QueryGroup(
                Occur.SHOULD,
                phrases=(
                    PhraseClause("text", ("a", "b")),
                    PhraseClause("name", ("a", "b")),
                ),
            ),
        )
    )
    pruned = prune_dead_phrases(two, df_of)
    assert len(pruned.groups[0].phrases) == 1
    assert pruned.groups[0].phrases[0].field == "text"

    # all-dead group keeps one alternative (still matches nothing)
    dead = QueryPlan(
        groups=(
            QueryGroup(
                Occur.MUST,
                phrases=(
                    PhraseClause("name", ("a", "b")),
                    PhraseClause("other", ("a", "b")),
                ),
            ),
        )
    )
    pruned = prune_dead_phrases(dead, df_of)
    assert len(pruned.groups[0].phrases) == 1

    # single-phrase groups pass through untouched (identity)
    one = _phrase_plan(["a", "b"])
    assert prune_dead_phrases(one, df_of) is one

    # live alternatives are kept
    df[("name", "a")] = 1
    df[("name", "b")] = 1
    assert prune_dead_phrases(two, df_of) is two


def test_prune_dead_term_alternatives():
    """Bare words expand to TermClause alternatives over text AND name
    (queryparser._leaf_group); dead name-field terms double the batch
    scorer's union-term lanes (measured 2.2x on parser-built 64-query
    batches) and must prune in every occur position."""
    from fugu_tpu.query import TermClause, prune_dead_alternatives

    df = {("text", "a"): 100, ("text", "b"): 50}

    def df_of(field, term):
        return df.get((field, term), 0)

    def word_group(occur, term):
        return QueryGroup(
            occur,
            clauses=(TermClause("text", term), TermClause("name", term)),
        )

    plan = QueryPlan(
        groups=(
            word_group(Occur.SHOULD, "a"),
            word_group(Occur.MUST, "b"),
            word_group(Occur.MUST_NOT, "a"),
        )
    )
    pruned = prune_dead_alternatives(plan, df_of)
    for g in pruned.groups:
        assert len(g.clauses) == 1 and g.clauses[0].field == "text", g

    # all-dead group keeps one clause (still matches nothing)
    dead = QueryPlan(groups=(word_group(Occur.MUST, "zzz"),))
    pruned = prune_dead_alternatives(dead, df_of)
    assert len(pruned.groups[0].clauses) == 1

    # mixed term+phrase group: dead members of both kinds prune together
    mixed = QueryPlan(
        groups=(
            QueryGroup(
                Occur.SHOULD,
                clauses=(TermClause("text", "a"), TermClause("name", "a")),
                phrases=(
                    PhraseClause("text", ("a", "b")),
                    PhraseClause("name", ("a", "b")),
                ),
            ),
        )
    )
    pruned = prune_dead_alternatives(mixed, df_of)
    g = pruned.groups[0]
    assert len(g.clauses) == 1 and len(g.phrases) == 1
    assert g.clauses[0].field == "text" and g.phrases[0].field == "text"

    # single-alternative groups pass through untouched (identity),
    # even when dead
    single = QueryPlan(groups=(QueryGroup(Occur.SHOULD, clauses=(TermClause("name", "a"),)),))
    assert prune_dead_alternatives(single, df_of) is single

    # subplans prune recursively
    nested = QueryPlan(
        groups=(QueryGroup(Occur.MUST, subplan=plan),)
    )
    pruned = prune_dead_alternatives(nested, df_of)
    for g in pruned.groups[0].subplan.groups:
        assert len(g.clauses) == 1


def test_pack_invalidated_on_delete(seg, stats):
    import copy

    s2 = copy.copy(seg)
    s2.tombstones = seg.tombstones.copy()
    pack1 = get_token_stream(s2, "text", stats)
    assert pack1 is not None
    # deleting any doc resets the cached stream; a fresh stats object
    # (fingerprint moves with tombstone counts) rebuilds it
    assert s2.delete_by_term("text", "w0") > 0
    st2 = oracle.IndexStats([s2])
    pack2 = get_token_stream(s2, "text", st2)
    assert pack2 is not pack1
    plan = _phrase_plan(["w1", "w2"])
    res = batch_phrase_search(s2, [plan], st2, [10], min_batch=1)
    assert _got(res[0]) == _expect(s2, st2, plan, 10)


def test_want_stream_model_overrides_auto_min(monkeypatch):
    """Above PHRASE_AUTO_MIN the cost model still decides when its inputs
    exist — on a flat-df corpus heavy phrases can stay cheap for the host
    matcher, so batch size alone must not force the sweep.  Without plans/stats the old AUTO_MIN
    fallback survives (there is nothing better to go on)."""
    from fugu_tpu.ops import phrase_stream as ps

    monkeypatch.delenv("FUGU_PHRASE_STREAM", raising=False)
    n = ps.PHRASE_AUTO_MIN + 32
    cheap = _FakeStats({"a": 300, "b": 900})  # flat corpus: tiny dfs
    plans = [_phrase_plan(["a", "b"]) for _ in range(n)]
    assert not ps.want_stream(n, plans=plans, stats=cheap)
    heavy = _FakeStats({"a": 963_000, "b": 999_000})
    assert ps.want_stream(n, plans=plans, stats=heavy)
    assert ps.want_stream(n)  # inputs missing: fallback unchanged
