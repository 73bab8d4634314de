"""device_idle: share of the traced segment with no kernel, copy or
memset record on the device."""


def read(run: dict):
    tr = run.get("trace")
    if not tr or not tr["busy_s"] or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
