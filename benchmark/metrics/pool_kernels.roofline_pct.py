"""pool_kernels.roofline_pct: the share of their memory roofline at which
the pool-with-mask and unpool ops and their gradients run: the bytes the
ops must move at the cell's shapes (``counts.pool_bytes`` over the
configuration's ``pool_sites``: each input byte read once, each output
byte written once) over the card's HBM bandwidth, divided by the device
time of the kernels whose names hold a line of
``pool_kernels.roofline_pct.patterns.txt``, over the traced iterations.
Nothing for a configuration with no pool sites, for a step driver that
does not count its passes, where no such kernel ran, or where the card's
bandwidth is not in the configuration's table."""
from pathlib import Path

from benchmark.counts import pool_bytes
from benchmark.trace import patterns

HERE = Path(__file__).resolve().parent


def read(run):
    sites = run.cfg.get("pool_sites")
    if run.trace is None or not sites:
        return None
    bandwidth = run.cfg["hbm_bytes_per_s"].get(run.device_name)
    names = patterns(HERE / "pool_kernels.roofline_pct.patterns.txt")
    seconds = run.trace.device_seconds(lambda n: any(p in n.lower() for p in names))
    passes = run.driver.passes()
    if not bandwidth or seconds <= 0 or not sum(passes):
        return None
    esize = 2 if run.cfg["precision"]["compute_dtype"] == "bfloat16" else 4
    per_iteration = pool_bytes(passes, int(run.cfg["height"]),
                               int(run.cfg["width"]), sites, esize)
    return 100.0 * per_iteration * run.traced_iterations / bandwidth / seconds
