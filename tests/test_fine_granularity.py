"""FUGU_FINE_PER_BLOCK parity: the phase-A maxima granularity is a pure
performance knob (how many per-block maxima phase A emits per 512-doc
kernel block), so every allowed value must produce bit-identical results
through the two-phase engine.  The suite default (2) is exercised by
every other batch-scorer test; this file covers the non-default values
by reloading the module under the env override.
"""

import importlib
import os

import numpy as np
import pytest

from fugu_tpu.index.schema import DOCS_SCHEMA
from fugu_tpu.index.segment import SegmentBuilder
from fugu_tpu.ops import oracle
from fugu_tpu.query import Occur, QueryGroup, QueryPlan, TermClause


@pytest.fixture(scope="module")
def seg():
    rng = np.random.default_rng(11)
    words = [f"w{i}" for i in range(40)]
    b = SegmentBuilder(DOCS_SCHEMA)
    for i in range(3000):
        text = " ".join(rng.choice(words, size=int(rng.integers(3, 20))))
        b.add_document(
            {"text": [text]},
            facets=[f"/cat/{int(rng.integers(0, 5))}"],
            stored={"id": f"d{i}"},
        )
    s = b.build()
    s.tombstones[::41] = True  # dead docs must drop out at every FINE
    return s


def _mixed_plans(rng):
    """Pure / MUST / MUST_NOT / facet-gate plans with mixed limits, so
    both the compact-mask path and the full-maxima 'upper' path (and the
    deep limit=100 extraction) run at the non-default granularity."""
    plans, limits = [], []
    for qi in range(12):
        n = int(rng.integers(1, 4))
        terms = rng.choice(40, size=n, replace=False)
        groups = [
            QueryGroup(Occur.SHOULD, (TermClause("text", f"w{t}"),))
            for t in terms
        ]
        r = qi % 4
        if r == 1:
            groups[0] = QueryGroup(Occur.MUST, groups[0].clauses)
        elif r == 2:
            groups.append(
                QueryGroup(
                    Occur.MUST_NOT,
                    (TermClause("text", f"w{int(rng.integers(0, 40))}"),),
                )
            )
        elif r == 3:
            groups.append(
                QueryGroup(
                    Occur.MUST,
                    (
                        TermClause(
                            "", f"/cat/{int(rng.integers(0, 5))}", is_facet=True
                        ),
                    ),
                )
            )
        plans.append(QueryPlan(groups=tuple(groups)))
        limits.append(100 if qi % 5 == 0 else 10)
    return plans, limits


def _reload_with(fine: str | None):
    import fugu_tpu.ops.batch_scorer as bs

    if fine is None:
        os.environ.pop("FUGU_FINE_PER_BLOCK", None)
    else:
        os.environ["FUGU_FINE_PER_BLOCK"] = fine
    return importlib.reload(bs)


@pytest.mark.parametrize("fine", [1, 4, 8])
def test_fine_per_block_parity(seg, fine):
    prev = os.environ.get("FUGU_FINE_PER_BLOCK")
    try:
        bs = _reload_with(str(fine))
        assert bs.FINE_PER_BLOCK == fine
        assert bs.BM_FINE_DOCS * fine == 512
        stats = oracle.IndexStats([seg])
        plans, limits = _mixed_plans(np.random.default_rng(7))
        res = bs.batch_search(seg, plans, stats, limits, min_batch=1)
        for plan, lim, got in zip(plans, limits, res):
            exp = [
                (h.score, h.doc)
                for h in oracle.search([seg], plan, lim, stats)
            ]
            assert got is not None
            assert [(np.float32(s), d) for s, d in got] == [
                (np.float32(s), d) for s, d in exp
            ], (fine, plan)
    finally:
        _reload_with(prev)


def test_planner_deep_stream_picks_fine4(seg):
    """Unpinned env: granularity is a per-stream planner decision —
    streams whose every live query extracts deep (limit > DEEP_LIMIT)
    take DEEP_FINE, mixed/shallow streams keep the default — and an
    all-deep batch stays bit-identical to the oracle through it."""
    prev = os.environ.get("FUGU_FINE_PER_BLOCK")
    try:
        bs = _reload_with(None)
        assert not bs._FINE_PINNED
        assert bs._fine_for_stream([0, 1, None], [100, 64]) == bs.DEEP_FINE
        assert bs._fine_for_stream([0, 1], [100, 10]) == bs.FINE_PER_BLOCK
        # boundary: DEEP_LIMIT itself is not deep (strictly greater)
        assert bs._fine_for_stream([0], [bs.DEEP_LIMIT]) == bs.FINE_PER_BLOCK
        stats = oracle.IndexStats([seg])
        plans, _ = _mixed_plans(np.random.default_rng(13))
        limits = [100] * len(plans)
        res = bs.batch_search(seg, plans, stats, limits, min_batch=1)
        for plan, lim, got in zip(plans, limits, res):
            exp = [
                (h.score, h.doc)
                for h in oracle.search([seg], plan, lim, stats)
            ]
            assert got is not None
            assert [(np.float32(s), d) for s, d in got] == [
                (np.float32(s), d) for s, d in exp
            ], plan
    finally:
        _reload_with(prev)


def test_pinned_env_overrides_planner():
    prev = os.environ.get("FUGU_FINE_PER_BLOCK")
    try:
        bs = _reload_with("2")
        assert bs._FINE_PINNED
        assert bs._fine_for_stream([0], [100]) == 2
        bs = _reload_with("8")
        assert bs._fine_for_stream([0], [100]) == 8
    finally:
        _reload_with(prev)


def test_fine_per_block_rejects_bad_values():
    # normalize prev BEFORE the failing reload: if the ambient env itself
    # carried an invalid value, the restoring reload in finally would
    # raise the same ValueError and mask the module's half-reloaded state
    prev = os.environ.get("FUGU_FINE_PER_BLOCK")
    if prev not in (None, "1", "2", "4", "8"):
        prev = None
    try:
        with pytest.raises(ValueError):
            _reload_with("3")
    finally:
        _reload_with(prev)
