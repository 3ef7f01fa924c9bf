"""Two-phase batch engine (corpus-stream phase A + pruned phase B):
oracle parity in interpret mode on the CPU backend."""

import numpy as np
import pytest

from fugu_tpu.index.schema import DOCS_SCHEMA
from fugu_tpu.index.segment import SegmentBuilder
from fugu_tpu.ops import oracle
from fugu_tpu.ops.batch_scorer import batch_search, batch_search_should
from fugu_tpu.query import Occur, QueryGroup, QueryPlan, TermClause


def assert_tie_tolerant(got, plan, seg, stats, limit):
    """Exact-equality check (name kept for history): device engines
    host-rescore their top-k with the oracle's float sequence, so on the
    CPU backend results must be BIT-IDENTICAL to the oracle."""
    exp = [(h.score, h.doc) for h in oracle.search([seg], plan, limit, stats)]
    assert got is not None
    assert [(np.float32(s), d) for s, d in got] == [
        (np.float32(s), d) for s, d in exp
    ], (got[:4], exp[:4])


@pytest.fixture(scope="module")
def seg():
    rng = np.random.default_rng(2)
    words = [f"w{i}" for i in range(50)]
    b = SegmentBuilder(DOCS_SCHEMA)
    for i in range(5000):
        text = " ".join(rng.choice(words, size=int(rng.integers(3, 25))))
        b.add_document(
            {"text": [text]},
            facets=[f"/cat/{int(rng.integers(0, 6))}"],
            stored={"id": f"d{i}"},
        )
    s = b.build()
    s.tombstones[::53] = True  # dead docs must be zeroed in phase A
    return s


def test_batch_scorer_parity(seg):
    stats = oracle.IndexStats([seg])
    rng = np.random.default_rng(4)
    plans = []
    for _ in range(24):
        n = int(rng.integers(1, 5))
        terms = rng.choice(50, size=n, replace=False)
        groups = [
            QueryGroup(Occur.SHOULD, (TermClause("text", f"w{t}"),))
            for t in terms
        ]
        if rng.random() < 0.25:
            groups.append(
                QueryGroup(
                    Occur.SHOULD,
                    (TermClause("", f"/cat/{int(rng.integers(0, 6))}", is_facet=True),),
                )
            )
        plans.append(QueryPlan(groups=tuple(groups)))
    res = batch_search_should(seg, plans, stats, 10, min_batch=1)
    for plan, r in zip(plans, res):
        assert_tie_tolerant(r, plan, seg, stats, 10)


def test_batch_scorer_skips_ineligible(seg):
    stats = oracle.IndexStats([seg])
    plans = [
        # non-default bm25 constants: precomputed contributions invalid
        QueryPlan(
            groups=(QueryGroup(Occur.SHOULD, (TermClause("text", "w0"),)),),
            k1=2.0,
        ),
        QueryPlan(match_all=True),
        # only MUST_NOT: nothing produces a positive bound
        QueryPlan(
            groups=(QueryGroup(Occur.MUST_NOT, (TermClause("text", "w1"),)),)
        ),
    ]
    res = batch_search_should(seg, plans, stats, 10, min_batch=1)
    assert res == [None, None, None]


def test_batch_scorer_constrained_parity(seg):
    """MUST / MUST_NOT / facet-MUST plans take the two-wave path and must
    match the oracle exactly (the phase-A bound is only an upper bound)."""
    stats = oracle.IndexStats([seg])
    rng = np.random.default_rng(11)
    plans = []
    for _ in range(12):  # intersections
        t = rng.choice(50, size=int(rng.integers(2, 4)), replace=False)
        plans.append(
            QueryPlan(
                groups=tuple(
                    QueryGroup(Occur.MUST, (TermClause("text", f"w{x}"),))
                    for x in t
                )
            )
        )
    for _ in range(8):  # exclusions
        t = rng.choice(50, size=3, replace=False)
        plans.append(
            QueryPlan(
                groups=(
                    QueryGroup(Occur.SHOULD, (TermClause("text", f"w{t[0]}"),)),
                    QueryGroup(Occur.SHOULD, (TermClause("text", f"w{t[1]}"),)),
                    QueryGroup(Occur.MUST_NOT, (TermClause("text", f"w{t[2]}"),)),
                ),
                require_should=True,
            )
        )
    for _ in range(8):  # facet-filtered
        t = rng.choice(50, size=int(rng.integers(1, 3)), replace=False)
        groups = [
            QueryGroup(Occur.SHOULD, (TermClause("text", f"w{x}"),)) for x in t
        ] + [
            QueryGroup(
                Occur.MUST,
                (TermClause("", f"/cat/{int(rng.integers(0, 6))}", is_facet=True),),
            )
        ]
        plans.append(QueryPlan(groups=tuple(groups)))
    res = batch_search_should(seg, plans, stats, 10, min_batch=1)
    for plan, r in zip(plans, res):
        assert_tie_tolerant(r, plan, seg, stats, 10)


def test_batch_scorer_mixed_limits_share_phase_a(seg):
    """batch_search takes per-plan limits; phase A is limit-independent."""
    stats = oracle.IndexStats([seg])
    plans = [
        QueryPlan(groups=(QueryGroup(Occur.SHOULD, (TermClause("text", "w5"),)),)),
        QueryPlan(groups=(QueryGroup(Occur.SHOULD, (TermClause("text", "w5"),)),)),
        QueryPlan(
            groups=(
                QueryGroup(Occur.MUST, (TermClause("text", "w5"),)),
                QueryGroup(Occur.MUST, (TermClause("text", "w6"),)),
            )
        ),
    ]
    limits = [10, 100, 100]
    res = batch_search(seg, plans, stats, limits, min_batch=1)
    for plan, lim, r in zip(plans, limits, res):
        assert_tie_tolerant(r, plan, seg, stats, lim)
    assert len(res[1]) > len(res[0])


def test_batch_scorer_constrained_underfill(seg):
    """A MUST intersection with almost no matches under-fills wave 1 and
    must fall through to the exhaustive candidate sweep, not truncate."""
    stats = oracle.IndexStats([seg])
    # find a 3-term combination with 0 < matches < 10
    plan = None
    rng = np.random.default_rng(13)
    for size in (3, 4, 5):
        if plan is not None:
            break
        for _ in range(300):
            t = rng.choice(50, size=size, replace=False)
            p = QueryPlan(
                groups=tuple(
                    QueryGroup(Occur.MUST, (TermClause("text", f"w{x}"),))
                    for x in t
                )
            )
            n = len(oracle.search([seg], p, 50, stats))
            if 0 < n < 10:
                plan = p
                break
    assert plan is not None, "corpus should contain a sparse MUST AND"
    res = batch_search_should(seg, [plan], stats, 10, min_batch=1)
    assert_tie_tolerant(res[0], plan, seg, stats, 10)


def test_batch_scorer_empty_and_missing_terms(seg):
    stats = oracle.IndexStats([seg])
    plans = [
        QueryPlan(
            groups=(QueryGroup(Occur.SHOULD, (TermClause("text", "zzz_absent"),)),)
        ),
        QueryPlan(groups=(QueryGroup(Occur.SHOULD, (TermClause("text", "w3"),)),)),
    ]
    res = batch_search_should(seg, plans, stats, 10, min_batch=1)
    assert res[0] == []
    exp = [(h.score, h.doc) for h in oracle.search([seg], plans[1], 10, stats)]
    assert [d for _, d in res[1]] == [d for _, d in exp]


def test_lane_plan_minimizes_lanes_with_stream_penalty():
    """Lane-fit partitioning: flops scale with padded lanes, but each
    extra corpus stream costs ~96 lanes of fixed overhead — splits only
    happen when they beat that."""
    from fugu_tpu.ops.batch_scorer import _lane_plan

    assert _lane_plan(64) == (64,)
    assert _lane_plan(96) == (128,)   # one 128-lane stream beats 64+64
    assert _lane_plan(136) == (256,)  # 64+128=192+96 penalty > 256
    assert _lane_plan(256) == (256,)
    # above one batch the planner still covers everything
    assert sum(_lane_plan(200)) >= 200


def test_batch_scorer_shift_kind_parity(seg):
    """require_should + MUST-facet plans classify as "shift": the
    constant facet score is excluded from W and added back to the
    maxima (now ON DEVICE in the compact path) — parity must hold."""
    from fugu_tpu.ops.batch_scorer import _classify

    stats = oracle.IndexStats([seg])
    rng = np.random.default_rng(13)
    plans = []
    for _ in range(26):  # >= MIN_BATCH so the device path engages
        t = rng.choice(50, size=int(rng.integers(1, 3)), replace=False)
        groups = [
            QueryGroup(Occur.SHOULD, (TermClause("text", f"w{x}"),)) for x in t
        ] + [
            QueryGroup(
                Occur.MUST,
                (TermClause("", f"/cat/{int(rng.integers(0, 6))}", is_facet=True),),
            )
        ]
        plans.append(QueryPlan(groups=tuple(groups), require_should=True))
    # round 3: these narrow-gate now (was "shift"); the parity assert
    # below still pins the require_should semantics bit-exactly
    assert all(_classify(p) == "gate" for p in plans)
    res = batch_search_should(seg, plans, stats, 10, min_batch=1)
    for plan, r in zip(plans, res):
        assert_tie_tolerant(r, plan, seg, stats, 10)


def test_classify_narrow_kinds(seg):
    from fugu_tpu.ops.batch_scorer import _classify

    def P(*groups, **kw):
        return QueryPlan(groups=tuple(groups), **kw)

    S = lambda t: QueryGroup(Occur.SHOULD, (TermClause("text", t),))
    N = lambda t: QueryGroup(Occur.MUST_NOT, (TermClause("text", t),))
    M = lambda t: QueryGroup(Occur.MUST, (TermClause("text", t),))
    F = lambda p: QueryGroup(Occur.MUST, (TermClause("", p, is_facet=True),))

    assert _classify(P(S("w1"), S("w2"))) == "pure"
    assert _classify(P(S("w1"), N("w2"))) == "neg"
    assert _classify(P(S("w1"), F("/cat/1"))) == "gate"
    assert _classify(P(S("w1"), F("/cat/1"), F("/cat/2"), N("w3"))) == "gate"
    assert _classify(P(M("w1"), M("w2"))) == "exact"
    # require_should + facet MUST gates too (threshold (n-0.5)*BIG keeps
    # the kth a valid lower bound; phase B enforces the true semantics)
    assert (
        _classify(P(S("w1"), F("/cat/1"), require_should=True)) == "gate"
    )
    # >4 gates: f32 granularity at score + n*GATE_BIG too coarse -> the
    # wide "shift" path (require_should) keeps it exact
    five = [F(f"/cat/{i}") for i in range(5)]
    assert _classify(P(S("w1"), *five, require_should=True)) == "shift"
    assert _classify(P(S("w1"), *five, require_should=False)) == "exact"


def test_neg_kind_parity_and_exclusion(seg):
    """MUST_NOT via score-lane W_MUSTNOT: excluded docs (including ones
    that would otherwise top the list) must vanish, everything else
    bit-identical to the oracle."""
    stats = oracle.IndexStats([seg])
    rng = np.random.default_rng(11)
    plans = []
    for _ in range(12):
        terms = rng.choice(50, size=3, replace=False)
        plans.append(
            QueryPlan(
                groups=(
                    QueryGroup(Occur.SHOULD, (TermClause("text", f"w{terms[0]}"),)),
                    QueryGroup(Occur.SHOULD, (TermClause("text", f"w{terms[1]}"),)),
                    QueryGroup(Occur.MUST_NOT, (TermClause("text", f"w{terms[2]}"),)),
                )
            )
        )
    # multi-clause MUST_NOT (any-of exclusion)
    plans.append(
        QueryPlan(
            groups=(
                QueryGroup(Occur.SHOULD, (TermClause("text", "w3"),)),
                QueryGroup(
                    Occur.MUST_NOT,
                    (TermClause("text", "w4"), TermClause("text", "w5")),
                ),
            )
        )
    )
    res = batch_search_should(seg, plans, stats, 10, min_batch=1)
    for plan, r in zip(plans, res):
        assert_tie_tolerant(r, plan, seg, stats, 10)


def test_gate_kind_parity(seg):
    """Facet MUSTs via GATE_BIG score gating: single and double gates,
    gate+mustnot combos, absent facets -> empty."""
    stats = oracle.IndexStats([seg])
    rng = np.random.default_rng(12)
    plans = []
    for _ in range(10):
        terms = rng.choice(50, size=2, replace=False)
        cat = int(rng.integers(0, 6))
        plans.append(
            QueryPlan(
                groups=(
                    QueryGroup(Occur.SHOULD, (TermClause("text", f"w{terms[0]}"),)),
                    QueryGroup(Occur.SHOULD, (TermClause("text", f"w{terms[1]}"),)),
                    QueryGroup(
                        Occur.MUST,
                        (TermClause("", f"/cat/{cat}", is_facet=True),),
                    ),
                )
            )
        )
    # double gate: ancestor + leaf facet both required
    plans.append(
        QueryPlan(
            groups=(
                QueryGroup(Occur.SHOULD, (TermClause("text", "w7"),)),
                QueryGroup(Occur.MUST, (TermClause("", "/cat", is_facet=True),)),
                QueryGroup(Occur.MUST, (TermClause("", "/cat/2", is_facet=True),)),
            )
        )
    )
    # gate + mustnot
    plans.append(
        QueryPlan(
            groups=(
                QueryGroup(Occur.SHOULD, (TermClause("text", "w8"),)),
                QueryGroup(Occur.MUST, (TermClause("", "/cat/3", is_facet=True),)),
                QueryGroup(Occur.MUST_NOT, (TermClause("text", "w9"),)),
            )
        )
    )
    # absent facet: MUST on a path nothing carries -> no hits
    plans.append(
        QueryPlan(
            groups=(
                QueryGroup(Occur.SHOULD, (TermClause("text", "w1"),)),
                QueryGroup(
                    Occur.MUST, (TermClause("", "/nope/zzz", is_facet=True),)
                ),
            )
        )
    )
    res = batch_search_should(seg, plans, stats, 10, min_batch=1)
    for plan, r in zip(plans, res):
        assert_tie_tolerant(r, plan, seg, stats, 10)
    assert res[-1] == []


def _must_plan(*terms, nots=()):
    groups = [
        QueryGroup(Occur.MUST, (TermClause("text", t),)) for t in terms
    ] + [QueryGroup(Occur.MUST_NOT, (TermClause("text", t),)) for t in nots]
    return QueryPlan(groups=tuple(groups))


def test_packed_count_lanes_parity(seg, monkeypatch):
    """FUGU_PACK_COUNTS=force bit-packs two queries' count columns per
    f32 lane; results must stay bit-identical to the oracle even with
    heavy term sharing across paired queries (bf16-conflicting pairs are
    re-ordered or left solo by _pack_order)."""
    import fugu_tpu.ops.batch_scorer as bs

    monkeypatch.setenv("FUGU_PACK_COUNTS", "force")
    engaged = {}
    orig = bs._pack_order

    def spy(q_idx, plans, tid_of, half):
        out = orig(q_idx, plans, tid_of, half)
        engaged["order"] = out
        return out

    monkeypatch.setattr(bs, "_pack_order", spy)
    stats = oracle.IndexStats([seg])
    rng = np.random.default_rng(23)
    plans = []
    for _ in range(26):
        # tiny term pool -> paired queries share MUST terms constantly
        t = rng.choice(10, size=int(rng.integers(2, 4)), replace=False)
        if rng.random() < 0.4:
            plans.append(_must_plan(*(f"w{x}" for x in t[:-1]), nots=(f"w{t[-1]}",)))
        else:
            plans.append(_must_plan(*(f"w{x}" for x in t)))
    res = batch_search_should(seg, plans, stats, 10, min_batch=1)
    assert engaged.get("order") is not None, "packing never engaged"
    for plan, r in zip(plans, res):
        assert_tie_tolerant(r, plan, seg, stats, 10)


def test_pack_order_repair_and_fail():
    from fugu_tpu.ops.batch_scorer import _count_weight_map, _pack_order

    tid_of = {("text", w): i for i, w in enumerate("abcxyz")}

    def compatible(p1, p2):
        m1 = _count_weight_map(p1, tid_of)
        m2 = _count_weight_map(p2, tid_of)
        return not any(t in m2 for t in m1)

    # greedy pairs (0,1) first; (2,3) conflict on x -> repair must split
    # into (0,2) + (3,1) to fit half=2
    plans = [
        _must_plan("a"),
        _must_plan("b"),
        _must_plan("x", "c"),
        _must_plan("x", "y"),
    ]
    out = _pack_order(list(range(4)), plans, tid_of, half=2)
    assert out is not None and len(out) == 4 and set(out) == {0, 1, 2, 3}
    for j in range(2):
        assert compatible(plans[out[j]], plans[out[j + 2]])

    # all four share a MUST term: no safe pairing fits half=2
    plans = [_must_plan("a", f"{extra}") for extra in "xyzc"]
    assert _pack_order(list(range(4)), plans, tid_of, half=2) is None

    # but with room for solos (half=4) packing still engages
    out = _pack_order(list(range(4)), plans, tid_of, half=4)
    assert out is not None and [i for i in out if i is not None] == [0, 1, 2, 3]


def test_merge_streams_folds_mixed_batch(seg, monkeypatch):
    """A mixed narrow+wide workload folds into ONE wide stream when the
    packed count lanes undercut the second stream's fixed cost; results
    stay bit-identical to the oracle (narrow kinds re-stage as their
    counted equivalents via _effective_kinds)."""
    import fugu_tpu.ops.batch_scorer as bs

    seen = {}
    orig = bs.stage_batch_weights

    def spy(plans, kinds, q_idx, *a, **kw):
        seen.setdefault("batches", []).append(
            [i for i in q_idx if i is not None]
        )
        return orig(plans, kinds, q_idx, *a, **kw)

    monkeypatch.setattr(bs, "stage_batch_weights", spy)
    stats = oracle.IndexStats([seg])
    rng = np.random.default_rng(31)
    plans = []
    for _ in range(10):  # pure
        t = rng.choice(50, size=2, replace=False)
        plans.append(
            QueryPlan(
                groups=tuple(
                    QueryGroup(Occur.SHOULD, (TermClause("text", f"w{x}"),))
                    for x in t
                )
            )
        )
    for _ in range(4):  # neg
        t = rng.choice(50, size=2, replace=False)
        plans.append(
            QueryPlan(
                groups=(
                    QueryGroup(Occur.SHOULD, (TermClause("text", f"w{t[0]}"),)),
                    QueryGroup(Occur.MUST_NOT, (TermClause("text", f"w{t[1]}"),)),
                ),
                require_should=True,
            )
        )
    for _ in range(4):  # gate (facet MUST + should)
        t = int(rng.integers(0, 50))
        plans.append(
            QueryPlan(
                groups=(
                    QueryGroup(Occur.SHOULD, (TermClause("text", f"w{t}"),)),
                    QueryGroup(
                        Occur.MUST,
                        (TermClause("", f"/cat/{int(rng.integers(0, 6))}", is_facet=True),),
                    ),
                ),
                require_should=True,
            )
        )
    for _ in range(6):  # wide: text MUSTs
        t = rng.choice(50, size=2, replace=False)
        plans.append(_must_plan(*(f"w{x}" for x in t)))
    res = batch_search_should(seg, plans, stats, 10, min_batch=1)
    # one merged stream, not a narrow + a wide one
    assert len(seen["batches"]) == 1, seen["batches"]
    assert sorted(seen["batches"][0]) == list(range(len(plans)))
    for plan, r in zip(plans, res):
        assert_tie_tolerant(r, plan, seg, stats, 10)


def test_effective_kinds_remap():
    from fugu_tpu.ops.batch_scorer import _classify, _effective_kinds

    pure = QueryPlan(
        groups=(QueryGroup(Occur.SHOULD, (TermClause("text", "a"),)),)
    )
    neg = QueryPlan(
        groups=(
            QueryGroup(Occur.SHOULD, (TermClause("text", "a"),)),
            QueryGroup(Occur.MUST_NOT, (TermClause("text", "b"),)),
        ),
        require_should=True,
    )
    gate_rs = QueryPlan(
        groups=(
            QueryGroup(Occur.SHOULD, (TermClause("text", "a"),)),
            QueryGroup(Occur.MUST, (TermClause("", "/c/1", is_facet=True),)),
        ),
        require_should=True,
    )
    gate = QueryPlan(
        groups=(
            QueryGroup(Occur.MUST, (TermClause("", "/c/1", is_facet=True),)),
        )
    )
    plans = [pure, neg, gate_rs, gate]
    kinds = {i: _classify(p) for i, p in enumerate(plans)}
    assert [kinds[i] for i in range(4)] == ["pure", "neg", "gate", "gate"]
    eff = _effective_kinds(plans, kinds, [0, 1, 2, 3], wide=True)
    assert [eff[i] for i in range(4)] == ["pure", "exact", "shift", "exact"]
    # narrow batches keep the score-lane kinds
    assert _effective_kinds(plans, kinds, [0, 1], wide=False) is kinds


def test_boosted_should_vs_mustnot_penalty():
    """A heavily boosted SHOULD must not out-score the "neg" kind's
    score-lane MUST_NOT penalty: plans with boost > 8 reroute to the
    count-lane "exact" staging (boost-immune -64 penalties).  Repro:
    excluded docs carrying huge boosted scores inflate block maxima so
    the kth-of-maxima threshold prunes every true match."""
    from fugu_tpu.ops.batch_scorer import _classify

    b = SegmentBuilder(DOCS_SCHEMA)
    for blk in range(24):
        for j in range(512):
            if j == 0 and blk < 12:
                # excluded doc: massive tf on the boosted term + 'bad'
                text = " ".join(["rare"] * 2000) + " bad"
            elif j < 4 and blk >= 12:
                text = "rare other"      # true matches live here
            else:
                text = "other filler"
            b.add_document({"text": [text]}, stored={"id": f"d{blk}-{j}"})
    seg = b.build()
    stats = oracle.IndexStats([seg])
    plan = QueryPlan(
        groups=(
            QueryGroup(Occur.SHOULD, (TermClause("text", "rare", boost=50000.0),)),
            QueryGroup(Occur.SHOULD, (TermClause("text", "other"),)),
            QueryGroup(Occur.MUST_NOT, (TermClause("text", "bad"),)),
        )
    )
    assert _classify(plan) == "exact"  # not "neg": boost cap exceeded
    res = batch_search_should(seg, [plan], stats, 10, min_batch=1)
    assert_tie_tolerant(res[0], plan, seg, stats, 10)
    assert len(res[0]) == 10


@pytest.mark.parametrize("limit", [100, 128])
def test_deep_limit_tie_parity(seg, limit):
    """Deep extraction through both phases on heavy (tie-rich) terms:
    results must be BIT-IDENTICAL to the oracle, including which tied
    docs survive at the limit (the (score desc, doc asc) rule)."""
    stats = oracle.IndexStats([seg])
    rng = np.random.default_rng(9)
    plans = []
    for _ in range(8):
        n = int(rng.integers(1, 4))
        terms = rng.choice(12, size=n, replace=False)  # heavy terms: ties
        plans.append(
            QueryPlan(
                groups=tuple(
                    QueryGroup(Occur.SHOULD, (TermClause("text", f"w{t}"),))
                    for t in terms
                )
            )
        )
    res = batch_search(seg, plans, stats, [limit] * len(plans),
                       min_batch=1)
    for plan, got in zip(plans, res):
        assert got is not None
        assert_tie_tolerant(got, plan, seg, stats, limit)


@pytest.mark.parametrize("layout", ["narrow", "wide", "packed"])
def test_phasea_kernel_vs_references(seg, layout):
    """The phase-A Triton kernel (interpret mode) against a NumPy
    reference of the same bf16 arithmetic (tight) and against the
    oracle's per-slice maxima (within the stated margin), in each lane
    layout."""
    import jax.numpy as jnp
    import ml_dtypes

    from fugu_tpu.ops import batch_scorer as bs

    stats = oracle.IndexStats([seg])
    rng = np.random.default_rng(21)
    b_pad = 64
    plans = []
    for i in range(b_pad):
        t = [f"w{x}" for x in rng.choice(50, size=2, replace=False)]
        occ = Occur.SHOULD if layout == "narrow" else (
            Occur.MUST if i % 2 else Occur.MUST_NOT
        )
        plans.append(QueryPlan(groups=(
            QueryGroup(Occur.SHOULD, (TermClause("text", t[0]),)),
            QueryGroup(occ, (TermClause("text", t[1]),)),
        )))
    pack = seg.block_major(stats)
    wide = layout != "narrow"
    packed = layout == "packed"
    q_idx = list(range(b_pad))
    if packed:
        q_idx = bs._pack_order(q_idx, plans, pack.tid_of, b_pad // 2)
    kinds = {i: bs._classify(p) for i, p in enumerate(plans)}
    eff = bs._effective_kinds(plans, kinds, q_idx, wide)
    terms = {}
    for i in q_idx:
        if i is not None:
            for t in bs._plan_tids(plans[i], pack.tid_of):
                terms.setdefault(t, len(terms))
    shifts = {}
    w2, nm, tids = bs.stage_batch_weights(
        plans, eff, q_idx, terms, stats, pack.tid_of, b_pad, wide,
        plans[0].k1, shifts, packed=packed,
    )
    nb_pad = bs._nb_pad(pack.n_blocks)
    fine = bs.FINE_PER_BLOCK
    fn = bs.phasea_callable(
        nb_pad, b_pad, wide, packed, fine,
        bs.n_terms_bucket(pack.n_terms), interpret=True,
    )
    got = np.asarray(fn(
        jnp.asarray(bs.pad_sub_offs(pack.sub_offs, nb_pad)), pack.d_doc,
        pack.d_tid, pack.d_con, jnp.asarray(w2, dtype=jnp.bfloat16),
        jnp.asarray(tids), jnp.asarray(nm),
    ))
    assert got.shape == (nb_pad, fine, b_pad)

    # NumPy reference of the kernel's arithmetic: bf16 w, bf16 con, the
    # product rounded to bf16, f64 sums, then the same masks
    bf = lambda a: np.asarray(a, np.float32).astype(ml_dtypes.bfloat16).astype(np.float64)
    doc = np.asarray(pack.d_doc)
    tid = np.asarray(pack.d_tid)
    con = np.asarray(pack.d_con.astype(jnp.float32), np.float64)
    slot = {int(t): u for u, t in enumerate(tids) if t >= 0}
    n_docs = nb_pad * 512
    wb = bf(w2)
    lanes = np.zeros((n_docs, w2.shape[1]))
    for e in np.nonzero((doc >= 0) & np.isin(tid, list(slot)))[0]:
        row = wb[slot[int(tid[e])]]
        v = row.copy()
        v[:b_pad] = bf(row[:b_pad] * con[e])
        lanes[doc[e]] += v
    scores = lanes[:, :b_pad]
    if wide:
        cnt = lanes[:, b_pad:]
        if packed:
            hi = np.floor(cnt / bs._PACK_FIELD + 0.5)
            lo = cnt - hi * bs._PACK_FIELD
            cnt = np.concatenate([lo, hi], axis=1)
        ok = (scores > 0) & (cnt > nm[None, :] - 0.5)
    else:
        ok = scores > nm[None, :]
    ref = np.where(ok, scores, -np.inf).reshape(nb_pad, fine, -1, b_pad).max(2)
    fin = np.isfinite(ref)
    assert np.array_equal(np.isfinite(got), fin)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=1e-5)

    # oracle per-slice maxima, within MARGIN_REL / MARGIN_ABS
    for qi, i in enumerate(q_idx[:16]):
        if i is None:
            continue
        sc, mask = oracle.score_segment(seg, plans[i], stats)
        v = np.full(n_docs, -np.inf, np.float32)
        v[: len(sc)] = np.where(mask, sc, -np.inf)
        want = v.reshape(-1, bs.BM_FINE_DOCS).max(axis=1)
        g = got[:, :, qi].reshape(-1) + shifts.get(i, 0.0)
        f = np.isfinite(want)
        assert np.array_equal(np.isfinite(g), f)
        assert np.all(
            np.abs(g[f] - want[f])
            <= np.abs(want[f]) * bs.MARGIN_REL + bs.MARGIN_ABS
        )
