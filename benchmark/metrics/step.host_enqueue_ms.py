"""step.host_enqueue_ms: host milliseconds an iteration from a window call's
start to its return, before the synchronize that ends it: the time the
host takes to enqueue the step's work; the median over the window's
calls."""
import statistics


def read(run):
    per_call = [(ret - start) / run.driver.T * 1e3 for start, ret, _ in run.calls]
    return statistics.median(per_call)
