"""device.idle_pct: the share of the traced window's span (host clock, from
its start to its synchronize) in which no kernel, memcpy or memset runs
on the device: one minus the union of the device intervals over the
span."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
