"""mfu: the traced rounds' model FLOPs (3 x forward a sample, no
recompute; ``portbench/flops/<config>.py``) over their wall time, as a
share of the TF32 dense peak."""
from portbench import yardstick


def read(rec: dict):
    wall = sum(r["end_ns"] - r["start_ns"] for r in rec["rounds"]) / 1e9
    flops = rec["flops_per_sample"] * sum(r["samples"] for r in rec["rounds"])
    return 100.0 * flops / wall / yardstick.PEAK_FLOPS if wall > 0 else None
