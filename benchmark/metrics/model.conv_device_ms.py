"""model.conv_device_ms: device milliseconds an iteration of the operations
launched inside a host operation whose name holds a line of
``model.conv_device_ms.patterns.txt`` (the convolutions, forward and
backward, and what cuDNN launches for them), over the traced iterations."""
from pathlib import Path

from benchmark.trace import patterns

HERE = Path(__file__).resolve().parent


def read(run):
    if run.trace is None:
        return None
    names = patterns(HERE / "model.conv_device_ms.patterns.txt")
    seconds = run.trace.device_seconds_under(lambda op: any(p in op.lower() for p in names))
    return seconds / run.traced_iterations * 1e3 if seconds > 0 else None
