"""``rdb_level_roofline``: the RDB kernel's share of its roofline over the
traced serving window. The bound sums, over every forward the window ran
and each of its RDBs, each level launch's max(FLOP / peak, bytes / peak)
at that forward's shape (the frozen per-level costs); the time is the
union of the device spans of the kernels named ``rdb_level*``. Nothing is
read where the program's launch count disagrees with the forwards, or no
such kernel ran."""

from port_bench.reference.costs import rdb_bound_s

LAUNCHES_PER_RDB = 5


def read(run):
    forwards = (run.trace_record or {}).get("forwards")
    if run.trace is None or not forwards:
        return None
    g = run.config["opt"]["network_G"]
    rdbs = 3 * g["nb"]
    if run.trace_counters.get("rdb_launches") != len(forwards) * rdbs * LAUNCHES_PER_RDB:
        return None
    kernel_s = run.trace.union_of("rdb_level")
    if not kernel_s:
        return None
    bound = sum(rdbs * rdb_bound_s(b, h, w, g["nf"], g["gc"]) for b, h, w in forwards)
    return 100.0 * bound / kernel_s
