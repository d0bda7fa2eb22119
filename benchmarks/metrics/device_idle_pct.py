"""device_idle_pct: share of the traced window in which no operation of
any client ran on the device (the union of the profiler's device
intervals), in percent."""


def read(rec):
    if rec["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])
