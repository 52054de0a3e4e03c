"""device_idle_pct (``device_idle_pct.batch``, ``device_idle_pct.online``):
share of the traced span with nothing running on the device."""


def read(run):
    p = run.profile
    if p is None or p.busy_s == 0:
        return None
    return 100.0 * (1.0 - p.busy_s / p.window_s)
