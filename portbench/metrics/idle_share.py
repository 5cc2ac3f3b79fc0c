"""idle_share: the share of the traced rounds' wall time in which no
device operation ran (one minus the union of their intervals)."""


def read(rec: dict):
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"]) if rec["window_s"] > 0 else None
