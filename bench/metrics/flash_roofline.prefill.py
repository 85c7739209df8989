"""Share of its bound that the flash kernel reaches: the frozen bound of
each `repro_torch::flash_attention` call (4·hd a causal pair a head at
989 TFLOP/s, or its bytes at 3.35 TB/s), summed, over the device time
launched under those calls.  A call is causal unless the trace
records its `causal` argument as false."""
from frozen.bounds import flash_bound_s

NEEDS_SHAPES = True


def read(r):
    if r.trace is None:
        return None
    bound = took = 0.0
    for args, s in r.trace.calls("repro_torch::flash_attention"):
        dims, types = args.get("Input Dims"), args.get("Input type")
        if not dims or s <= 0:
            continue
        concrete = args.get("Concrete Inputs") or []
        causal = len(concrete) < 4 or concrete[3] not in ("False", "0", False)
        bound += flash_bound_s(dims[0], dims[1], types[0], causal)
        took += s
    return 100.0 * bound / took if took > 0 else None
