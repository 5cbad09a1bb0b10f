"""model.bn_device_ms: device milliseconds an iteration of the operations
launched inside a host operation whose name holds a line of
``model.bn_device_ms.patterns.txt`` (batch norm's statistics, normalisation
and gradients; the running-statistic updates outside those operations are
not counted), over the traced iterations."""
from pathlib import Path

from benchmark.trace import patterns

HERE = Path(__file__).resolve().parent


def read(run):
    if run.trace is None:
        return None
    names = patterns(HERE / "model.bn_device_ms.patterns.txt")
    seconds = run.trace.device_seconds_under(lambda op: any(p in op.lower() for p in names))
    return seconds / run.traced_iterations * 1e3 if seconds > 0 else None
