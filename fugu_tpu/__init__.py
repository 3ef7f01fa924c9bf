"""fugu_tpu — a namespace-scoped full-text index-and-query engine whose
query path runs as JAX programs on a GPU.

A ground-up rebuild of the capability surface of ``mycorrhiza-inc/fugu``
(a Rust HTTP search service wrapping Tantivy 0.24):

- the inverted index lives as fixed-width, block-padded posting packs in
  device memory;
- BM25 scoring, boolean combination (AND/OR/NOT), filter-bitset fusion and
  top-k selection run as vectorized JAX/XLA + Pallas (Triton) programs;
- segments are immutable; a compactor merges them and purges tombstones;
- multi-device operation shards documents by id range over a
  ``jax.sharding.Mesh`` and merges per-shard top-k with collectives.

The host side (tokenization, term/facet dictionaries, doc store, HTTP API,
config) is Python, mirroring the reference's layer map (see SURVEY.md §1).
"""

from fugu_tpu.version import __version__
from fugu_tpu.records import ObjectRecord, ValidationError
from fugu_tpu.config import ServerConfig, NamespaceConfig, ValidationConfig

__all__ = [
    "__version__",
    "ObjectRecord",
    "ValidationError",
    "ServerConfig",
    "NamespaceConfig",
    "ValidationConfig",
]
