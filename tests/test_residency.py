"""HBM residency manager (ops/residency): LRU budget accounting across
device packs, correct queries with evicted packs re-uploading on demand.

The reference gets this arbitration free from the OS page cache over
mmap'd segments (`/root/reference/src/db/core.rs:238`); a
device-resident engine owns it explicitly.
"""

import numpy as np
import pytest

from fugu_tpu.index.schema import DOCS_SCHEMA
from fugu_tpu.index.segment import SegmentBuilder
from fugu_tpu.ops import oracle, residency
from fugu_tpu.ops.batch_scorer import batch_search
from fugu_tpu.query import Occur, QueryGroup, QueryPlan, TermClause


def _make_seg(n_docs, seed):
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(25)]
    b = SegmentBuilder(DOCS_SCHEMA)
    for _ in range(n_docs):
        b.add_document(
            {"text": [" ".join(rng.choice(words, size=12))]}, stored={}
        )
    return b.build()


@pytest.fixture(autouse=True)
def _clean():
    residency.reset_for_test()
    yield
    residency.reset_for_test()


def _plans(rng, n):
    out = []
    for _ in range(n):
        terms = rng.choice(25, size=2, replace=False)
        out.append(
            QueryPlan(
                groups=tuple(
                    QueryGroup(Occur.SHOULD, (TermClause("text", f"w{t}"),))
                    for t in terms
                )
            )
        )
    return out


def test_budget_parsing(monkeypatch):
    monkeypatch.setenv("FUGU_DEVICE_MEM_BUDGET", "2G")
    assert residency.budget_bytes() == 2 * 2**30
    monkeypatch.setenv("FUGU_DEVICE_MEM_BUDGET", "512m")
    assert residency.budget_bytes() == 512 * 2**20
    monkeypatch.setenv("FUGU_DEVICE_MEM_BUDGET", "0")
    assert residency.budget_bytes() is None
    monkeypatch.setenv("FUGU_DEVICE_MEM_BUDGET", "12345")
    assert residency.budget_bytes() == 12345


class _Dev:
    platform = "gpu"
    device_kind = "NVIDIA H100 80GB HBM3"
    stats = None

    def memory_stats(self):
        return self.stats


def _auto_budget_with(monkeypatch, dev):
    import jax

    monkeypatch.setattr(jax, "local_devices", lambda: [dev])
    monkeypatch.setenv("FUGU_DEVICE_MEM_BUDGET", "auto")
    residency._budget_cache = None
    try:
        return residency.budget_bytes()
    finally:
        residency._budget_cache = None


def test_auto_budget_kind_fallback(monkeypatch):
    """"auto" on an accelerator takes 85% of the allocator limit the
    backend reports (GPU-shaped memory_stats)."""
    dev = _Dev()
    dev.stats = {"bytes_limit": 60 * 2**30, "bytes_in_use": 0}
    assert _auto_budget_with(monkeypatch, dev) == int(60 * 2**30 * 0.85)


def test_auto_budget_without_stats_raises(monkeypatch):
    """An accelerator that reports no memory stats is an error, not an
    unlimited budget."""
    with pytest.raises(RuntimeError, match="bytes_limit"):
        _auto_budget_with(monkeypatch, _Dev())


def test_lru_eviction_bounds_memory(monkeypatch):
    segs = [_make_seg(600, s) for s in range(4)]
    stats = [oracle.IndexStats([s]) for s in segs]
    # one block-major pack per segment; measure one to size the budget
    segs[0].block_major(stats[0])
    one = residency.stats()["resident_bytes"]
    assert one > 0
    monkeypatch.setenv("FUGU_DEVICE_MEM_BUDGET", str(int(one * 2.5)))
    for s, st in zip(segs, stats):
        s.block_major(st)
    rs = residency.stats()
    assert rs["resident_bytes"] <= int(one * 2.5)
    assert rs["evictions"] >= 2
    # evicted packs are gone from their segments; touched ones remain
    n_resident = sum(
        1 for s in segs if getattr(s, "_block_major", None) is not None
    )
    assert n_resident == rs["resident_packs"] == 2
    # queries against an evicted segment re-upload and stay CORRECT
    rng = np.random.default_rng(0)
    plans = _plans(rng, 4)
    for s, st in zip(segs, stats):
        res = batch_search(s, plans, st, [10] * len(plans), min_batch=1)
        for plan, got in zip(plans, res):
            exp = [
                (np.float32(h.score), h.doc)
                for h in oracle.search([s], plan, 10, st)
            ]
            assert [(np.float32(a), d) for a, d in got] == exp
        assert residency.stats()["resident_bytes"] <= int(one * 2.5)


def test_oversized_pack_raises_and_host_serves(monkeypatch):
    seg = _make_seg(600, 9)
    stats = oracle.IndexStats([seg])
    monkeypatch.setenv("FUGU_DEVICE_MEM_BUDGET", "1024")
    with pytest.raises(RuntimeError):
        seg.block_major(stats)
    # the host oracle still answers (the engine's fallback path)
    plan = _plans(np.random.default_rng(1), 1)[0]
    hits = oracle.search([seg], plan, 5, stats)
    assert hits


def test_touch_protects_hot_pack(monkeypatch):
    residency.reset_for_test()
    segs = [_make_seg(600, 20 + s) for s in range(3)]
    stats = [oracle.IndexStats([s]) for s in segs]
    segs[0].block_major(stats[0])
    one = residency.stats()["resident_bytes"]
    monkeypatch.setenv("FUGU_DEVICE_MEM_BUDGET", str(int(one * 2.5)))
    segs[1].block_major(stats[1])
    segs[0].block_major(stats[0])  # touch 0: now 1 is the LRU
    segs[2].block_major(stats[2])  # evicts 1, not 0
    assert getattr(segs[0], "_block_major", None) is not None
    assert getattr(segs[1], "_block_major", None) is None
    assert getattr(segs[2], "_block_major", None) is not None


def test_entry_pack_and_token_stream_accounted():
    seg = _make_seg(600, 31)
    stats = oracle.IndexStats([seg])
    seg.device_pack()
    from fugu_tpu.ops.phrase_stream import get_token_stream

    get_token_stream(seg, "text", stats)
    kinds = residency.stats()["by_kind"]
    assert "entry" in kinds and "token_stream" in kinds
    # delete invalidates caches AND accounting
    assert seg.delete_by_term("text", "w1") > 0
    kinds = residency.stats()["by_kind"]
    assert "entry" not in kinds and "token_stream" not in kinds
