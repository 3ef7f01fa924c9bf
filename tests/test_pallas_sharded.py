"""Batched sharded block scorer: oracle parity on 1-D and 2-D meshes.

Runs on the 8-virtual-device CPU mesh (conftest); the same program and
shard_map specs compile for a mesh of GPUs.
"""

import numpy as np
import pytest

from fugu_tpu.index.schema import DOCS_SCHEMA
from fugu_tpu.index.segment import SegmentBuilder
from fugu_tpu.ops import oracle
from fugu_tpu.parallel.pallas_sharded import (
    PallasShardedPack,
    pallas_sharded_search_batch,
)
from fugu_tpu.parallel.sharded import make_mesh
from fugu_tpu.query import Occur, QueryGroup, QueryPlan, TermClause


@pytest.fixture(scope="module")
def seg():
    rng = np.random.default_rng(3)
    words = [f"w{i}" for i in range(40)]
    b = SegmentBuilder(DOCS_SCHEMA)
    for i in range(2500):
        text = " ".join(rng.choice(words, size=int(rng.integers(3, 20))))
        b.add_document(
            {"text": [text]},
            facets=[f"/cat/{int(rng.integers(0, 5))}"],
            stored={"id": f"d{i}"},
        )
    s = b.build()
    s.tombstones[::83] = True  # fused tombstone filtering is exercised
    return s


PLANS = [
    # pure SHOULD disjunction
    QueryPlan(
        groups=tuple(
            QueryGroup(Occur.SHOULD, (TermClause("text", w),))
            for w in ("w0", "w1", "w2")
        )
    ),
    # MUST + SHOULD + MUST_NOT + facet filter fusion
    QueryPlan(
        groups=(
            QueryGroup(Occur.MUST, (TermClause("text", "w3"),)),
            QueryGroup(Occur.SHOULD, (TermClause("text", "w4"),)),
            QueryGroup(Occur.MUST_NOT, (TermClause("text", "w5"),)),
            QueryGroup(Occur.MUST, (TermClause("", "/cat/1", is_facet=True),)),
        )
    ),
    # single term
    QueryPlan(groups=(QueryGroup(Occur.SHOULD, (TermClause("text", "w7"),)),)),
    # intersection of two heavy terms
    QueryPlan(
        groups=(
            QueryGroup(Occur.MUST, (TermClause("text", "w0"),)),
            QueryGroup(Occur.MUST, (TermClause("text", "w1"),)),
        )
    ),
]


def _assert_parity(got, plan, seg, limit=10):
    """Bit-exact: the sharded scorer host-rescores its top-k with the
    oracle's float sequence, so CPU-backend results must be identical."""
    stats = oracle.IndexStats([seg])
    exp = oracle.search([seg], plan, limit, stats)
    assert [(np.float32(s), d) for s, d in (got or [])] == [
        (np.float32(h.score), h.doc) for h in exp
    ], (got, [(h.score, h.doc) for h in exp])


@pytest.mark.parametrize("n_slices", [1, 2])
def test_pallas_sharded_batch_parity(seg, n_slices):
    mesh = make_mesh(8, n_slices=n_slices)
    pack = PallasShardedPack(seg, mesh)
    stats = oracle.IndexStats([seg])
    res = pallas_sharded_search_batch(pack, PLANS, stats, 10)
    assert all(r is not None for r in res)
    for plan, r in zip(PLANS, res):
        _assert_parity(r, plan, seg)


def test_engine_sharded_batch(tmp_path, monkeypatch):
    """NamedIndex under a mesh batches the whole query list through the
    Pallas sharded engine (FUGU_ENGINE=pallas forces it on small segs)."""
    from fugu_tpu.engine.dataset import Dataset
    from fugu_tpu.records import ObjectRecord

    monkeypatch.setenv("FUGU_ENGINE", "pallas")
    monkeypatch.setattr(
        "fugu_tpu.engine.named_index.DEVICE_MIN_ENTRIES", 1
    )
    ds = Dataset("meshns", tmp_path, use_device=True)
    ds.ingest(
        [
            ObjectRecord(
                id=f"m{i}",
                text=f"alpha w{i % 16} beta w{(i * 7) % 16}",
                namespace="meshns",
            )
            for i in range(400)
        ]
    )
    mesh = make_mesh(8)
    ds.docs().enable_sharding(mesh)
    batch = ds.search_many(
        [("alpha w1", []), ("beta w3", []), ("w5 w6", [])], 0, 5
    )
    assert len(batch) == 3 and all(len(b) > 0 for b in batch)
    # same results as the un-sharded oracle-checked path
    ds2 = Dataset("meshns", tmp_path, use_device=False)
    for (q, _), hits in zip([("alpha w1", []), ("beta w3", []), ("w5 w6", [])], batch):
        exp = ds2.search(q, [], 0, 5)
        assert [h.id for h in hits] == [h.id for h in exp] or np.allclose(
            [h.score for h in hits], [h.score for h in exp], rtol=1e-5
        )


def test_manager_config_sharding(tmp_path, monkeypatch):
    """FUGU_SHARD_DEVICES wires the mesh in with zero code (VERDICT #3)."""
    from fugu_tpu.config import ServerConfig
    from fugu_tpu.engine.manager import DatasetManager
    from fugu_tpu.records import ObjectRecord

    monkeypatch.setenv("FUGU_SHARD_DEVICES", "8")
    cfg = ServerConfig.with_defaults(str(tmp_path), "shardns")
    assert cfg.shard_devices == 8
    mgr = DatasetManager(cfg, use_device=True)
    assert mgr._mesh is not None and mgr._mesh.devices.size == 8
    ds = mgr.default_dataset()
    assert ds.docs()._mesh is mgr._mesh
    ds.ingest(
        [
            ObjectRecord(id=f"s{i}", text=f"gamma doc w{i % 8}", namespace="shardns")
            for i in range(64)
        ]
    )
    res = ds.search("gamma w3", [], 0, 5)
    assert res


def test_engine_autoselect(monkeypatch):
    from fugu_tpu.engine import named_index as ni

    class FakeSeg:
        doc_count = 10_000

    class BigSeg:
        doc_count = 1_000_000

    monkeypatch.delenv("FUGU_ENGINE", raising=False)
    assert ni._engine_name(FakeSeg()) == "xla"
    assert ni._engine_name(BigSeg()) == "pallas"
    monkeypatch.setenv("FUGU_ENGINE", "xla")
    assert ni._engine_name(BigSeg()) == "xla"
    monkeypatch.setenv("FUGU_ENGINE", "pallas")
    assert ni._engine_name(FakeSeg()) == "pallas"


def test_block_heavy_shards_split_into_slice_rows(seg, monkeypatch):
    """Regression: a shard with more nonempty blocks than the SMEM table
    budget (NB_BUCKETS[-1]) used to overflow the staged block_ids table
    (seen live: 489 blocks into a 256-wide table on a 1-device mesh).
    Shrinking the budget forces the block-slice row path; slices
    partition doc space so parity must hold."""
    from fugu_tpu.parallel import pallas_sharded as ps

    monkeypatch.setattr(ps, "NB_BUCKETS", (1,))
    mesh = make_mesh(1)  # one shard holds ALL (2) blocks -> 2 slice rows
    pack = PallasShardedPack(seg, mesh)
    stats = oracle.IndexStats([seg])
    res = pallas_sharded_search_batch(pack, PLANS, stats, 10)
    # the budget actually bites: the single shard spans >1 kernel block,
    # so a 1-block slice limit forces multiple rows per plan
    assert pack.n_blocks > 1
    for plan, r in zip(PLANS, res):
        if r is None:
            continue
        _assert_parity(r, plan, seg)
    assert any(r is not None for r in res)
