"""Live-stack load harness: concurrent search load over real HTTP.

Measures what `bench.py` deliberately excludes — the serving layers
(aiohttp parse/route, micro-batcher, executor, JSON serialize) wrapped
around the engine — and attributes the gap stage by stage from the
server's own /metrics histograms (queue wait / exec wait / engine /
serialize, added in commit 3061db7).

Reference analog: the full axum pipeline
(`/root/reference/src/server/server_main.rs:44-109`); the reference
publishes no load numbers, so this is our own scoreboard.

Usage (expects the 1M bench corpus cached by bench.py):

    python tools/live_load.py --concurrency 64,128 --requests 2048

The load client shares this host's ONE core with the server; the
printed per-stage breakdown is exactly the instrument that separates
server-side cost from client-side cost (VERDICT r3 weak #5).
"""

from __future__ import annotations

import argparse
import asyncio
import json
import shutil
import socket
import sys
import threading
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).parent.parent))

from fugu_tpu.config import ServerConfig
from fugu_tpu.engine.manager import DatasetManager
from fugu_tpu.server.app import create_app

CACHE = Path(__file__).parent.parent / ".bench_cache"

STAGES = [
    ("fugu_search_queue_wait_seconds", "queue wait (batch window)"),
    ("fugu_search_exec_wait_seconds", "executor wait"),
    ("fugu_search_engine_seconds", "engine (search_many)"),
    ("fugu_search_serialize_seconds", "serialize (json.dumps)"),
    ("fugu_search_seconds", "request total (server-side)"),
]


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def adopt_corpus(data_dir: Path, n_docs: int) -> None:
    """Mount the cached bench segment as the default namespace's docs
    index: hardlink the segment files and write a generation-1 manifest
    (same layout `index/manifest.py` commits)."""
    seg_id = f"benchv1{n_docs}"
    src = CACHE / f"seg-{seg_id}.npz"
    if not src.exists():
        raise SystemExit(
            f"no cached corpus {src} — run `BENCH_DOCS={n_docs} python "
            "bench.py` (or just its build_corpus) first"
        )
    docs_dir = data_dir / "default" / "docs"
    docs_dir.mkdir(parents=True, exist_ok=True)
    import os

    for suffix in (".npz", ".store.msgpack", ".tomb.npy"):
        s = CACHE / f"seg-{seg_id}{suffix}"
        d = docs_dir / s.name
        if s.exists() and not d.exists():
            os.link(s, d)
    (docs_dir / "meta.json").write_text(
        json.dumps(
            {
                "generation": 1,
                "segments": [{"id": seg_id, "doc_count": n_docs}],
            }
        )
    )


def make_queries(n_docs: int, n: int = 512) -> list:
    """Mixed text-query set over the bench vocabulary, df-weighted like
    bench.make_query_mix — but as PARSER text (the HTTP surface's input),
    not engine plans."""
    rng = np.random.default_rng(11)
    # bench vocab: t00000..t29999 Zipf-1.07 — low ids are frequent
    p = 1.0 / np.arange(1, 30_000 + 1) ** 1.07
    p /= p.sum()

    def pick(k):
        return [f"t{i:05d}" for i in rng.choice(30_000, size=k, replace=False, p=p)]

    out = []
    for i in range(n):
        c = i % 8
        if c < 3:  # should
            out.append(" ".join(pick(3)))
        elif c < 5:  # must
            a, b = pick(2)
            out.append(f"+{a} +{b}")
        elif c == 5:  # mustnot
            a, b, neg = pick(3)
            out.append(f"{a} {b} -{neg}")
        elif c == 6:  # phrase
            a, b = pick(2)
            out.append(f'"{a} {b}"')
        else:  # boosted disjunction
            a, b, cc = pick(3)
            out.append(f"{a}^2 {b} {cc}")
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Server:
    def __init__(self, data_dir: Path):
        cfg = ServerConfig.with_defaults(str(data_dir), "default")
        self.db = DatasetManager(cfg)
        self.port = _free_port()
        self.base = f"http://127.0.0.1:{self.port}"
        self._loop = asyncio.new_event_loop()
        self._up = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        if not self._up.wait(30):
            raise SystemExit("server failed to start")

    def _run(self):
        asyncio.set_event_loop(self._loop)

        async def boot():
            app = create_app(self.db)
            runner = web.AppRunner(app)
            await runner.setup()
            site = web.TCPSite(runner, "127.0.0.1", self.port)
            await site.start()
            self._runner = runner
            self._up.set()

        from aiohttp import web

        self._loop.run_until_complete(boot())
        self._loop.run_forever()


async def drive(base: str, bodies: list, concurrency: int, total: int):
    """N worker coroutines pulling pre-serialized bodies off one list."""
    import aiohttp

    idx = 0
    lock = asyncio.Lock()
    errors = []

    async def worker(session):
        nonlocal idx
        while True:
            async with lock:
                if idx >= total:
                    return
                i = idx
                idx += 1
            body = bodies[i % len(bodies)]
            async with session.post(
                base + "/search/json",
                data=body,
                headers={"Content-Type": "application/json"},
            ) as resp:
                raw = await resp.read()
                if resp.status != 200:
                    errors.append((resp.status, raw[:200]))

    conn = aiohttp.TCPConnector(limit=concurrency)
    # first-touch compiles can take minutes (remote Mosaic helper)
    tmo = aiohttp.ClientTimeout(total=1800)
    async with aiohttp.ClientSession(connector=conn, timeout=tmo) as session:
        t0 = time.perf_counter()
        await asyncio.gather(*(worker(session) for _ in range(concurrency)))
        dt = time.perf_counter() - t0
    return dt, errors


def scrape(base: str) -> dict:
    import urllib.request

    with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
        text = r.read().decode()
    out = {}
    for line in text.splitlines():
        for name, _ in STAGES:
            if line.startswith(name + "_sum "):
                out[name + "_sum"] = float(line.split()[1])
            elif line.startswith(name + "_count "):
                out[name + "_count"] = int(line.split()[1])
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--docs", type=int, default=1_000_000)
    ap.add_argument("--concurrency", default="64,128")
    ap.add_argument("--requests", type=int, default=2048)
    ap.add_argument("--keep-data", action="store_true")
    args = ap.parse_args()

    data_dir = Path("/tmp/fugu_live_load")
    if not args.keep_data and data_dir.exists():
        shutil.rmtree(data_dir)
    adopt_corpus(data_dir, args.docs)
    log(f"corpus adopted: {args.docs} docs")
    srv = Server(data_dir)
    log(f"server up at {srv.base}")

    queries = make_queries(args.docs)
    bodies = [
        json.dumps({"query": q, "page": {"page": 0, "per_page": 10}}).encode()
        for q in queries
    ]

    # warmup: compile every signature — loop until
    # two consecutive passes agree within 15% (bench.py's protocol),
    # bounded at 10 passes
    log("warmup...")
    prev = 0.0
    for i in range(10):
        dt, errs = asyncio.run(drive(srv.base, bodies, 64, 256))
        qps = 256 / dt
        log(f"  warm pass {i}: {qps:.1f} QPS, {len(errs)} errors")
        if errs:
            log(f"  first error: {errs[0]}")
            raise SystemExit("warmup errors")
        if prev and abs(qps - prev) / max(qps, prev) < 0.15:
            break
        prev = qps

    results = []
    for conc in [int(c) for c in args.concurrency.split(",")]:
        # untimed full-coverage pass at THIS level's concurrency first:
        # batch composition (hence u_pad/b_pad bucket mix) depends on
        # both, and a shape's first use in a process pays a
        # persistent-cache executable load (or a compile if truly new),
        # which must not land inside a timed level.
        _dt, werrs = asyncio.run(
            drive(srv.base, bodies, conc, max(args.requests, len(bodies)))
        )
        if werrs:
            log(f"  level-warm errors: {werrs[0]}")
            raise SystemExit("level warmup errors")
        before = scrape(srv.base)
        dt, errs = asyncio.run(drive(srv.base, bodies, conc, args.requests))
        after = scrape(srv.base)
        qps = args.requests / dt
        log(f"\n== {conc}-way: {qps:.1f} QPS ({args.requests} reqs in {dt:.1f}s, "
            f"{len(errs)} errors)")
        stages = {}
        for name, label in STAGES:
            ds = after.get(name + "_sum", 0) - before.get(name + "_sum", 0)
            dc = after.get(name + "_count", 0) - before.get(name + "_count", 0)
            mean_ms = 1000 * ds / dc if dc else 0.0
            stages[name] = {
                "mean_ms": round(mean_ms, 3),
                "sum_s": round(ds, 3),
                "count": dc,
            }
            log(f"   {label:32s} mean {mean_ms:8.2f} ms   total {ds:7.2f} s"
                f"   n={dc}")
        # engine count = batches dispatched; queue count = requests
        nb = stages["fugu_search_engine_seconds"]["count"]
        if nb:
            log(f"   -> {nb} batches, avg {args.requests / nb:.1f} queries/"
                f"batch, engine {1000 * stages['fugu_search_engine_seconds']['sum_s'] / args.requests:.2f} ms/request")
        results.append({"concurrency": conc, "qps": round(qps, 1),
                        "errors": len(errs), "batches": nb, "stages": stages})
    print(json.dumps(results))


if __name__ == "__main__":
    main()
