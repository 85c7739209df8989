"""Share of its bound that the intra-chunk SSD kernel reaches: the frozen
bound of each `repro_torch::ssd_intra` call (C·Bᵀ once a chunk and
group, M·X a head, at 989 TFLOP/s, or its bytes at 3.35 TB/s), summed,
over the device time launched under those calls."""
from frozen.bounds import ssd_bound_s

NEEDS_SHAPES = True


def read(r):
    if r.trace is None:
        return None
    bound = took = 0.0
    for args, s in r.trace.calls("repro_torch::ssd_intra"):
        dims, types = args.get("Input Dims"), args.get("Input type")
        if not dims or s <= 0:
            continue
        bound += ssd_bound_s(dims, types)
        took += s
    return 100.0 * bound / took if took > 0 else None
