"""Device-resident feature cache (paper §6.5 as a measurement),
`repro/featcache`.

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
rate (`GNNTrainer(cache=...)`).

Admission comes in two flavors: STATIC (a frozen `CachePlan`) and DYNAMIC
(`featcache.dynamic`: `CachePlan.to_dynamic()` / `cache="dynamic"` — a
trainer-carried CLOCK second-chance state whose reference bits come from
the extended `gather_cached` counters and whose residency is re-admitted
at epoch boundaries by `dynamic.refill`, a hand-written CUDA walk on the
card, bit-matched to the reference's numpy oracle). The LRU / CLOCK
simulators live in `featcache.sim`.
"""
from repro_torch.featcache.dynamic import (DynamicCacheState,  # noqa: F401
                                           as_cache)
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
from repro_torch.kernels.gather_cached.ops import (  # noqa: F401
    cache_ref_updates, cache_stats, gather_cached)


__all__ = [
    "AdmissionPolicy", "CachePlan", "CLOCK_TIE_BREAK",
    "CommunityFreqAdmission", "DegreeHotAdmission", "DynamicCacheState",
    "PresampledFreqAdmission", "as_admission", "as_cache", "as_plan",
    "available_admissions", "build_plan", "cache_ref_updates",
    "cache_ref_updates_np",
    "cache_stats", "cache_stats_np", "clock_miss_rate", "clock_replay",
    "gather_cached", "lru_miss_rate", "make_admission",
    "policy_access_stream", "register_admission", "select_rows",
    "static_miss_rate",
]
