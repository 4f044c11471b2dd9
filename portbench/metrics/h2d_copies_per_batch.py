"""Host-to-device copies in the profiled stretch (the profiler's Memcpy
HtoD records) per device batch the service pulled in it
(utils/torchenv.py uploads)."""


def read(ctx):
    b = sum(v[0] for v in ctx["prof_delta"]["by_kind"].values())
    n = sum(1 for cat, name, _a, _b in ctx["prof"]["device"]
            if cat == "gpu_memcpy" and "HtoD" in name)
    return n / b if b and n else None
