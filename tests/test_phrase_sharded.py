"""Sharded phrase stream (parallel/phrase_sharded): oracle parity on
the 8-virtual-device CPU mesh — the phrase kernel under shard_map with
GSPMD-gathered global top-K bounds and shard-windowed host phase B.

Every served result must be bit-identical to oracle.search (scores AND
tie ordering), exactly like the single-chip stream engine's contract.
"""

import numpy as np
import pytest

from fugu_tpu.index.schema import DOCS_SCHEMA
from fugu_tpu.index.segment import SegmentBuilder
from fugu_tpu.ops import oracle
from fugu_tpu.parallel.phrase_sharded import batch_phrase_search_sharded
from fugu_tpu.parallel.sharded import make_mesh
from fugu_tpu.query import Occur, PhraseClause, QueryGroup, QueryPlan


def _phrase_plan(words, occur=Occur.SHOULD, slop=0, boost=1.0):
    return QueryPlan(
        groups=(
            QueryGroup(
                occur,
                phrases=(
                    PhraseClause("text", tuple(words), boost=boost, slop=slop),
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
    rng = np.random.default_rng(31)
    words = [f"w{i}" for i in range(30)]
    b = SegmentBuilder(DOCS_SCHEMA)
    # 5003 docs: a deliberately odd count so the 8-way (s*n)//d split
    # puts uneven ranges on shards and block tails hit shard bounds
    for i in range(5003):
        n = int(rng.integers(4, 26))
        text = " ".join(rng.choice(words, size=n))
        vals = [text]
        if i % 9 == 0:
            vals = [text, " ".join(rng.choice(words, size=5))]
        b.add_document({"text": vals}, stored={"id": f"d{i}"})
    # one long doc spanning chunks, near a shard boundary by id
    b.add_document(
        {"text": [" ".join(["w1 w2"] * 1200)]}, stored={"id": "long"}
    )
    s = b.build()
    s.tombstones[::41] = True
    return s


@pytest.fixture(scope="module")
def stats(seg):
    return oracle.IndexStats([seg])


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(8)


def test_sharded_phrase_parity(seg, stats, mesh):
    rng = np.random.default_rng(3)
    plans, limits = [], []
    for _ in range(20):
        w = rng.integers(0, 30, size=2)
        plans.append(_phrase_plan([f"w{w[0]}", f"w{w[1]}"]))
        limits.append(int(rng.choice([3, 10, 50])))
    res = batch_phrase_search_sharded(
        seg, mesh, plans, stats, limits, min_batch=1
    )
    for plan, lim, got in zip(plans, limits, res):
        assert got is not None, plan
        assert _got(got) == _expect(seg, stats, plan, lim), plan


def test_sharded_phrase_slop_boost_and_lengths(seg, stats, mesh):
    plans = [
        _phrase_plan(["w1"]),
        _phrase_plan(["w1", "w2", "w3"]),
        _phrase_plan(["w1", "w3"], slop=1),
        _phrase_plan(["w2", "w4"], slop=2, boost=1.7),
        _phrase_plan(["w0", "zz-absent"]),
        _phrase_plan(["w5", "w6"], occur=Occur.MUST),
    ]
    limits = [5, 10, 10, 10, 10, 100]
    res = batch_phrase_search_sharded(
        seg, mesh, plans, stats, limits, min_batch=1
    )
    for plan, lim, got in zip(plans, limits, res):
        assert got is not None, plan
        assert _got(got) == _expect(seg, stats, plan, lim), plan
    assert res[4] == []


def test_sharded_matches_single_chip(seg, stats, mesh):
    """The sharded engine and the single-chip stream engine must agree
    exactly (both anchored to the oracle, but compare directly too)."""
    from fugu_tpu.ops.phrase_stream import batch_phrase_search

    plans = [_phrase_plan([f"w{i}", f"w{(i + 3) % 30}"]) for i in range(10)]
    limits = [10] * len(plans)
    sharded = batch_phrase_search_sharded(
        seg, mesh, plans, stats, limits, min_batch=1
    )
    single = batch_phrase_search(seg, plans, stats, limits, min_batch=1)
    for plan, a, b in zip(plans, sharded, single):
        assert a is not None and b is not None
        assert _got(a) == _got(b), plan


def test_sharded_tombstones_and_long_doc(seg, stats, mesh):
    plan = _phrase_plan(["w1", "w2"])
    res = batch_phrase_search_sharded(
        seg, mesh, [plan], stats, [3], min_batch=1
    )
    assert _got(res[0]) == _expect(seg, stats, plan, 3)
    assert res[0][0][1] == seg.doc_count - 1  # the long doc tops on tf
    dead = set(np.nonzero(seg.tombstones)[0].tolist())
    assert not ({d for _s, d in res[0]} & dead)


def test_sharded_residency_registered(seg, stats, mesh):
    from fugu_tpu.ops import residency

    batch_phrase_search_sharded(
        seg, mesh, [_phrase_plan(["w1", "w2"])], stats, [5], min_batch=1
    )
    st = residency.stats()
    assert st["by_kind"].get("token_stream", 0) > 0


def test_sharded_stream_evicted_then_reserved(seg, stats, mesh, monkeypatch):
    """Evicting the sharded token stream (budget pressure) must drop the
    cache so the next search re-uploads and re-registers — and results
    stay bit-identical across the cycle."""
    from fugu_tpu.ops import residency

    plans = [_phrase_plan(["w1", "w2"]), _phrase_plan(["w2", "w3"], slop=1)]
    first = batch_phrase_search_sharded(
        seg, mesh, plans, stats, [5, 5], min_batch=1
    )
    key = ("stok", id(seg), "text")
    assert residency.contains(key)
    # simulate LRU pressure: a tiny budget evicts everything resident
    monkeypatch.setenv("FUGU_DEVICE_MEM_BUDGET", "1")
    residency.reserve(("probe", 0), 1, seg, lambda _o: None, kind="probe")
    assert not residency.contains(key)
    assert getattr(seg, "_sharded_token_stream", {}) == {}
    monkeypatch.setenv("FUGU_DEVICE_MEM_BUDGET", "auto")
    residency.unregister(("probe", 0))
    second = batch_phrase_search_sharded(
        seg, mesh, plans, stats, [5, 5], min_batch=1
    )
    assert first == second
    assert residency.contains(key)
