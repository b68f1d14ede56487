"""idle_share (%): the share of the traced window in which no operation ran
on the device (one minus the union of the trace's device events)."""


def read(rec):
    tr = rec.get("trace")
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
