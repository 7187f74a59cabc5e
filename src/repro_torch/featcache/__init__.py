"""Device-resident feature cache (paper §6.5 as a measurement), the static
half of `repro/featcache`.

    from repro_torch import featcache

    plan = featcache.build_plan(graph, "presampled_freq", capacity=4096,
                                policy=policy, batch_size=512,
                                fanouts=(10, 10), device="cuda")
    rows, hits, misses = featcache.gather_cached(
        plan.cache, feats, plan.pos, ids)

A `CachePlan` pins the hottest feature rows (chosen by a registered
admission policy — `degree_hot` / `community_freq` / `presampled_freq`)
into a compact `(C, F)` device tensor with an `int32[N]` position map;
`repro_torch.kernels.gather_cached` serves every layer-0 feature read
through it (cache row on hit, global matrix on miss) and counts hits on
the device, so the paper's cache-locality claim becomes a measured hit
rate (`GNNTrainer(cache=...)`). The LRU / CLOCK simulators live in
`featcache.sim`. Dynamic (CLOCK) admission is not ported yet.
"""
from repro_torch.featcache.plan import (AdmissionPolicy, CachePlan,  # noqa: F401
                                        CommunityFreqAdmission,
                                        DegreeHotAdmission,
                                        PresampledFreqAdmission,
                                        as_admission, as_plan,
                                        available_admissions, build_plan,
                                        cache_ref_updates_np,
                                        cache_stats_np, make_admission,
                                        register_admission, select_rows)
from repro_torch.featcache.sim import (CLOCK_TIE_BREAK,  # noqa: F401
                                       clock_miss_rate, clock_replay,
                                       lru_miss_rate, policy_access_stream,
                                       static_miss_rate)
from repro_torch.kernels.gather_cached.ops import (cache_stats,  # noqa: F401
                                                   gather_cached)


def as_cache(obj, graph, **kw):
    """Normalize any cache spec the trainer and the stream accept: None
    and a `CachePlan` pass through; an admission name or instance builds a
    static plan (`build_plan(graph, obj, **kw)`). `"dynamic"` and
    `"dynamic:<admission>"` raise: dynamic admission is not ported yet."""
    if isinstance(obj, str) and (obj == "dynamic"
                                 or obj.startswith("dynamic:")):
        raise ValueError(f"cache={obj!r}: dynamic (CLOCK) admission is not "
                         f"ported yet; pass a static admission name "
                         f"{available_admissions()} or a CachePlan")
    return as_plan(obj, graph, **kw)


__all__ = [
    "AdmissionPolicy", "CachePlan", "CLOCK_TIE_BREAK",
    "CommunityFreqAdmission", "DegreeHotAdmission",
    "PresampledFreqAdmission", "as_admission", "as_cache", "as_plan",
    "available_admissions", "build_plan", "cache_ref_updates_np",
    "cache_stats", "cache_stats_np", "clock_miss_rate", "clock_replay",
    "gather_cached", "lru_miss_rate", "make_admission",
    "policy_access_stream", "register_admission", "select_rows",
    "static_miss_rate",
]
