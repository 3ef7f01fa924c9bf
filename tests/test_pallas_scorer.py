"""Block scorer (plain XLA) vs oracle."""

import numpy as np
import pytest

from fugu_tpu.index.schema import DOCS_SCHEMA
from fugu_tpu.index.segment import SegmentBuilder
from fugu_tpu.ops import oracle
from fugu_tpu.ops.pallas_scorer import pallas_search_batch
from fugu_tpu.query import Occur, QueryGroup, QueryPlan, TermClause

VOCAB = [f"w{i}" for i in range(60)]


def make_segment(n_docs=5000, seed=0):
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, len(VOCAB) + 1)
    p /= p.sum()
    b = SegmentBuilder(DOCS_SCHEMA)
    for i in range(n_docs):
        words = rng.choice(VOCAB, size=int(rng.integers(2, 30)), p=p)
        b.add_document(
            {"text": [" ".join(words)]},
            facets=[f"/cat/{int(rng.integers(0, 5))}"],
            stored={"id": f"d{i}"},
        )
    return b.build()


@pytest.fixture(scope="module")
def seg():
    return make_segment()


def check(seg, plan, limit=10):
    stats = oracle.IndexStats([seg])
    got = pallas_search_batch(seg, [plan], stats, limit)[0]
    assert got is not None
    expected = oracle.search([seg], plan, limit, stats)
    assert len(got) == len(expected), (got, expected)
    for (gs, gd), h in zip(got, expected):
        if gd != h.doc:
            assert gs == pytest.approx(h.score, rel=1e-5)
        assert gs == pytest.approx(h.score, rel=1e-5, abs=1e-6)


def plan_terms(*words, occur=Occur.SHOULD):
    return QueryPlan(
        groups=tuple(
            QueryGroup(occur, (TermClause("text", w),)) for w in words
        )
    )


def test_single_term(seg):
    check(seg, plan_terms("w0"))


def test_sparse_term(seg):
    check(seg, plan_terms("w55"), limit=20)


def test_multi_term_or(seg):
    check(seg, plan_terms("w0", "w3", "w9"), limit=15)


def test_must(seg):
    check(seg, plan_terms("w0", "w1", occur=Occur.MUST), limit=25)


def test_mustnot(seg):
    plan = QueryPlan(
        groups=(
            QueryGroup(Occur.SHOULD, (TermClause("text", "w0"),)),
            QueryGroup(Occur.MUST_NOT, (TermClause("text", "w1"),)),
        )
    )
    check(seg, plan, limit=20)


def test_facet_filter(seg):
    plan = QueryPlan(
        groups=(
            QueryGroup(Occur.MUST, (TermClause("text", "w1"),)),
            QueryGroup(Occur.MUST, (TermClause("", "/cat/2", is_facet=True),)),
        )
    )
    check(seg, plan, limit=20)


def test_tombstones(seg):
    seg.tombstones[:500] = True
    seg._device_pack = None
    seg._device_tomb_flags = None
    try:
        check(seg, plan_terms("w0", "w2"), limit=20)
    finally:
        seg.tombstones[:] = False
        seg._device_pack = None
        seg._device_tomb_flags = None


def test_batched_mixed(seg):
    stats = oracle.IndexStats([seg])
    plans = [
        plan_terms("w0"),
        plan_terms("w1", "w4"),
        plan_terms("w2", "w5", "w7"),
        plan_terms("w50"),
    ]
    got = pallas_search_batch(seg, plans, stats, 10)
    for plan, res in zip(plans, got):
        assert res is not None
        exp = oracle.search([seg], plan, 10, stats)
        assert len(res) == len(exp)
        for (gs, gd), h in zip(res, exp):
            if gd != h.doc:
                assert gs == pytest.approx(h.score, rel=1e-5)


def test_small_segment_single_block():
    seg = make_segment(n_docs=100, seed=3)
    check(seg, plan_terms("w0", "w1"))


def test_empty_result():
    seg = make_segment(n_docs=50, seed=4)
    stats = oracle.IndexStats([seg])
    plan = plan_terms("zzz_absent")
    res = pallas_search_batch(seg, [plan], stats, 10)
    assert res[0] == []


def test_block_slice_split(seg, monkeypatch):
    """Block-heavy queries split into <=NB_SPLIT-block rows whose top-k
    lists merge on the host; forcing NB_SPLIT=1 makes every block its
    own row and must still reproduce the oracle exactly."""
    from fugu_tpu.ops import pallas_scorer as ps

    monkeypatch.setattr(ps, "NB_SPLIT", 1)
    check(seg, plan_terms("w0", "w3"))
    check(seg, plan_terms("w0", "w5", occur=Occur.MUST))


def test_k_up_to_128(seg):
    """limits in (64, 128] run on-device now (MAX_K == K_OUT == 128);
    beyond that the engine returns None and the caller falls back."""
    from fugu_tpu.ops import pallas_scorer as ps

    check(seg, plan_terms("w1"), limit=100)
    stats = oracle.IndexStats([seg])
    out = ps.pallas_search_batch(seg, [plan_terms("w1")], stats, 129)
    assert out == [None]


def test_group_bit_31_no_overflow(seg):
    """A 32-group plan puts group index 31's bit at 2**31, which
    overflows an int32 numpy mask assignment unless wrapped to
    two's-complement (ops.scoring.mask_i32).  30 clauseless SHOULD
    groups keep t_pad small so the plan reaches dispatch."""
    groups = (
        (QueryGroup(Occur.SHOULD, (TermClause("text", "w0"),)),)
        + tuple(QueryGroup(Occur.SHOULD, ()) for _ in range(30))
        + (QueryGroup(Occur.MUST_NOT, (TermClause("text", "w1"),)),)
    )
    plan = QueryPlan(groups=groups)
    assert len(plan.groups) == 32
    check(seg, plan, limit=20)


@pytest.mark.parametrize("limit", [100, 128])
def test_topk_parity_and_ties(limit):
    """The block scorer's top-k must reproduce the oracle exactly at deep
    limits on a corpus where >128 docs tie on the same score class (the
    doc-asc tiebreak decides WHICH docs survive extraction —
    candidate-set equality matters, not just ordering)."""
    b = SegmentBuilder(DOCS_SCHEMA)
    # 8000 docs across >3 blocks; a 30% minority matches "foo bar" with
    # the same tf and fieldnorm -> a >128-deep score tie at POSITIVE
    # weights (an all-docs term flips idf negative via tombstoned df and
    # routes off the device engines entirely — separate test below)
    for i in range(8000):
        text = (
            "foo bar baz qux" if i % 3 == 0 else "filler words only here"
        )
        b.add_document({"text": [text]}, stored={"id": f"t{i}"})
    # a few strictly-better docs scattered across blocks
    for i in range(7):
        b.add_document({"text": ["foo foo foo bar"]}, stored={"id": f"hi{i}"})
    s = b.build()
    s.tombstones[::97] = True
    stats = oracle.IndexStats([s])
    plan = plan_terms("foo", "bar")

    got = pallas_search_batch(s, [plan], stats, limit)[0]
    assert got is not None
    exp = [
        (np.float32(h.score), h.doc)
        for h in oracle.search([s], plan, limit, stats)
    ]
    assert [(np.float32(sc), d) for sc, d in got] == exp


def test_negative_idf_routes_off_device(monkeypatch):
    """r5 regression: tombstone-inflated df (df > live N) flips idf
    negative; the device engines' 'scores > 0 == matched' convention
    silently dropped ALL hits for such plans (found while building the
    tie corpus above).  They must decline (None) so the host chain
    serves the negatively-scored hits exactly."""
    from fugu_tpu.ops import pallas_scorer as ps
    from fugu_tpu.ops.batch_scorer import batch_search
    from fugu_tpu.ops.blockmax import search_blockmax
    from fugu_tpu.ops.scoring import device_search_segment

    b = SegmentBuilder(DOCS_SCHEMA)
    for i in range(5000):
        b.add_document({"text": ["foo bar baz"]}, stored={"id": f"t{i}"})
    s = b.build()
    s.tombstones[::61] = True  # df (5000) > live doc count
    stats = oracle.IndexStats([s])
    plan = plan_terms("foo", "bar")
    exp = [
        (np.float32(h.score), h.doc)
        for h in oracle.search([s], plan, 50, stats)
    ]
    assert exp and exp[0][0] < 0  # the regime under test
    assert ps.pallas_search_batch(s, [plan], stats, 50) == [
        None
    ]
    assert batch_search(s, [plan], stats, [50], min_batch=1) == [None]
    # the XLA merge-network path matches by group bits (not scores > 0)
    # and stays EXACT under negative weights — it keeps serving
    xla = device_search_segment(s, plan, stats, 50)
    assert xla is not None
    assert [(np.float32(sc), d) for sc, d in xla] == exp
    got = search_blockmax(s, plan, stats, 50)
    if got is not None:  # host chain stays exact either way
        assert [(np.float32(sc), d) for sc, d in got] == exp


def test_deep_limit_with_slice_split(monkeypatch):
    """Deep extraction under NB_SPLIT=1 (every block its own row): per-row
    top-k lists merge on the host and must stay exact."""
    from fugu_tpu.ops import pallas_scorer as ps

    monkeypatch.setattr(ps, "NB_SPLIT", 1)
    seg = make_segment()
    check(seg, plan_terms("w0", "w3"), limit=100)
    check(seg, plan_terms("w0", "w5", occur=Occur.MUST), limit=20)
