"""repro_torch.data — the streaming data/Gram subsystem, in torch.

Port of ``repro.data``.  HP-CONCORD consumes the Gram matrix S = XᵀX/n,
never X itself; this package turns arbitrarily large row-streams of X
into that (p, p) float64 sufficient statistic on the card, with bounded
memory, plus the synthetic worlds to exercise it:

  shards      chunk sources: in-memory arrays and tensors, iterators,
              memory-mapped ``.npy``/raw shard files (the reference's
              file formats) — one ``ChunkSource`` protocol
  transforms  per-chunk transforms (``none``/``center``/``standardize``
              one-pass via streamed moments; ``rank`` — the
              nonparanormal transform — bounded two-pass)
  gram        ``GramAccumulator`` (chunked, f64 on the device, Welford
              one-pass stats), ``compute_gram`` front door
              (``distributed_gram`` belongs to the distributed slice)
  scenarios   5 graph families as (Ω_true, seeded chunked sampler)
              pairs with exact controlled condition number

    from repro_torch.data import compute_gram, make_scenario
    sc = make_scenario("scale_free", p=512, cond=20.0)
    g = compute_gram(sc.source(n=1_000_000), transform="standardize")
    ConcordEstimator(lam1=0.15).fit_gram(g)

Everything runs on the CUDA card unless given ``device="cpu"``.
"""
from .gram import (  # noqa: F401
    GramAccumulator,
    GramResult,
    compute_gram,
    distributed_gram,
    rank_gram,
)
from .scenarios import (  # noqa: F401
    SCENARIO_FAMILIES,
    Scenario,
    available_families,
    make_scenario,
    register_family,
)
from .shards import (  # noqa: F401
    ChunkSource,
    as_source,
    open_shards,
    write_shards,
)
from .transforms import (  # noqa: F401
    StreamStats,
    Transform,
    available_transforms,
    get_transform,
    register_transform,
)

__all__ = [
    "ChunkSource",
    "GramAccumulator",
    "GramResult",
    "SCENARIO_FAMILIES",
    "Scenario",
    "StreamStats",
    "Transform",
    "as_source",
    "available_families",
    "available_transforms",
    "compute_gram",
    "distributed_gram",
    "get_transform",
    "make_scenario",
    "open_shards",
    "rank_gram",
    "register_family",
    "register_transform",
    "write_shards",
]
