"""optimizer.device_ms: device milliseconds an iteration of the operations
launched inside torch's ``Optimizer.step#<Optimizer>.step`` spans, over the
traced iterations."""


def read(run):
    if run.trace is None:
        return None
    seconds = run.trace.device_seconds_under(lambda op: op.startswith("Optimizer.step#"))
    return seconds / run.traced_iterations * 1e3 if seconds > 0 else None
