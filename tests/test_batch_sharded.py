"""Sharded two-phase batch engine: oracle parity on the 8-virtual-device
CPU mesh (phase A under shard_map in interpret mode, GSPMD-gathered
device thresholding, pruned sharded phase B)."""

import numpy as np
import pytest

from fugu_tpu.index.schema import DOCS_SCHEMA
from fugu_tpu.index.segment import SegmentBuilder
from fugu_tpu.ops import oracle
from fugu_tpu.parallel.batch_sharded import (
    ShardedBlockMajor,
    batch_search_sharded,
)
from fugu_tpu.parallel.pallas_sharded import PallasShardedPack
from fugu_tpu.parallel.sharded import make_mesh
from fugu_tpu.query import Occur, QueryGroup, QueryPlan, TermClause


@pytest.fixture(scope="module")
def seg():
    rng = np.random.default_rng(21)
    words = [f"w{i}" for i in range(40)]
    b = SegmentBuilder(DOCS_SCHEMA)
    for i in range(6000):
        text = " ".join(rng.choice(words, size=int(rng.integers(3, 20))))
        b.add_document(
            {"text": [text]},
            facets=[f"/cat/{int(rng.integers(0, 5))}"],
            stored={"id": f"d{i}"},
        )
    s = b.build()
    s.tombstones[::67] = True
    return s


def make_plans(rng, n):
    plans = []
    for _ in range(n):
        kind = rng.random()
        t = rng.choice(40, size=int(rng.integers(1, 4)), replace=False)
        if kind < 0.5:  # pure SHOULD
            groups = [
                QueryGroup(Occur.SHOULD, (TermClause("text", f"w{x}"),))
                for x in t
            ]
            plans.append(QueryPlan(groups=tuple(groups)))
        elif kind < 0.75:  # intersections ("exact")
            groups = [
                QueryGroup(Occur.MUST, (TermClause("text", f"w{x}"),))
                for x in t
            ]
            plans.append(QueryPlan(groups=tuple(groups)))
        else:  # facet-filtered ("exact"/"shift")
            groups = [
                QueryGroup(Occur.SHOULD, (TermClause("text", f"w{x}"),))
                for x in t
            ] + [
                QueryGroup(
                    Occur.MUST,
                    (TermClause("", f"/cat/{int(rng.integers(0, 5))}", is_facet=True),),
                )
            ]
            plans.append(
                QueryPlan(
                    groups=tuple(groups),
                    require_should=bool(rng.random() < 0.5),
                )
            )
    return plans


@pytest.mark.parametrize(
    "n_dev,n_slices", [(2, 1), (4, 1), (4, 2)]
)
def test_sharded_two_phase_parity(seg, n_dev, n_slices):
    # (4, 2) = the 2-D ("dcn", "d") multi-slice mesh: phase A shards over
    # the flattened grid and the maxima gather crosses both axes
    mesh = make_mesh(n_dev, n_slices=n_slices)
    stats = oracle.IndexStats([seg])
    pack2 = ShardedBlockMajor(seg, mesh, stats)
    spack = PallasShardedPack(seg, mesh)
    rng = np.random.default_rng(5)
    plans = make_plans(rng, 20)
    limits = [int(rng.choice([5, 10])) for _ in plans]
    res = batch_search_sharded(
        pack2, spack, plans, stats, limits, min_batch=1
    )
    n_handled = 0
    for plan, lim, r in zip(plans, limits, res):
        if r is None:
            continue
        n_handled += 1
        exp = [(h.score, h.doc) for h in oracle.search([seg], plan, lim, stats)]
        # engines host-rescore with the oracle's float sequence: on CPU
        # results are bit-identical, not merely tie-tolerant
        assert [(np.float32(s), d) for s, d in r] == [
            (np.float32(s), d) for s, d in exp
        ], (r[:4], exp[:4])
    assert n_handled >= len(plans) // 2  # the engine takes most plans


def test_sharded_two_phase_through_named_index(tmp_path):
    """Engine-level: enable_sharding routes search_topk_batch through the
    sharded two-phase engine with exact cross-checks vs the oracle."""
    from fugu_tpu.engine.manager import DatasetManager
    from fugu_tpu.records import ObjectRecord

    rng = np.random.default_rng(6)
    words = [f"w{i}" for i in range(30)]
    mgr = DatasetManager.with_defaults(str(tmp_path), "sh")
    ds = mgr.get_or_create_dataset("sh")
    ds.batch_upsert(
        [
            ObjectRecord(
                id=f"r{i}", text=" ".join(rng.choice(words, size=7))
            )
            for i in range(3000)
        ]
    )
    idx = ds._docs
    idx.enable_sharding(make_mesh(4))
    stats = idx.stats()
    segs = idx.searcher_segments()
    plans = make_plans(rng, 6)
    for plan in plans:
        hits = idx.search_topk(plan, 10)
        exp = oracle.search(segs, plan, 10, stats)
        got = [(np.float32(h.score), h.doc) for h in hits]
        want = [(np.float32(h.score), h.doc) for h in exp]
        assert got == want


def test_sharded_packed_and_merged_streams_parity(seg, monkeypatch):
    """FUGU_PACK_COUNTS=force + stream merging through the SHARDED
    engine: mixed narrow (SHOULD) + wide (MUST/MUST_NOT) plans fold into
    one packed stream per the flop model; results stay bit-identical to
    the oracle on the CPU mesh."""
    import fugu_tpu.parallel.batch_sharded as bsh

    monkeypatch.setenv("FUGU_PACK_COUNTS", "force")
    engaged = {}
    orig = bsh._pack_order

    def spy(q_idx, plans, tid_of, half):
        out = orig(q_idx, plans, tid_of, half)
        engaged["order"] = out
        return out

    monkeypatch.setattr(bsh, "_pack_order", spy)
    mesh = make_mesh(4)
    stats = oracle.IndexStats([seg])
    pack2 = ShardedBlockMajor(seg, mesh, stats)
    spack = PallasShardedPack(seg, mesh)
    rng = np.random.default_rng(11)
    plans = []
    for _ in range(24):
        t = rng.choice(12, size=int(rng.integers(2, 4)), replace=False)
        r = rng.random()
        if r < 0.4:  # narrow SHOULD
            groups = [
                QueryGroup(Occur.SHOULD, (TermClause("text", f"w{x}"),))
                for x in t
            ]
        elif r < 0.8:  # wide: MUST intersections (count lanes)
            groups = [
                QueryGroup(Occur.MUST, (TermClause("text", f"w{x}"),))
                for x in t
            ]
        else:  # wide: MUST + MUST_NOT
            groups = [
                QueryGroup(Occur.MUST, (TermClause("text", f"w{x}"),))
                for x in t[:-1]
            ] + [
                QueryGroup(Occur.MUST_NOT, (TermClause("text", f"w{t[-1]}"),))
            ]
        plans.append(QueryPlan(groups=tuple(groups)))
    limits = [int(rng.choice([5, 10])) for _ in plans]
    res = batch_search_sharded(
        pack2, spack, plans, stats, limits, min_batch=1
    )
    assert engaged.get("order") is not None, "packing never engaged"
    n_handled = 0
    for plan, lim, r in zip(plans, limits, res):
        if r is None:
            continue
        n_handled += 1
        exp = [(h.score, h.doc) for h in oracle.search([seg], plan, lim, stats)]
        assert [(np.float32(s), d) for s, d in r] == [
            (np.float32(s), d) for s, d in exp
        ], (plan, r[:4], exp[:4])
    assert n_handled >= len(plans) // 2
