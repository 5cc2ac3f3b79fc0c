"""kernels_per_round: device kernels launched a round, from the trace."""


def read(rec: dict):
    n = sum(1 for _, kind, _, _ in rec["ops"] if kind == "kernel")
    return n / len(rec["rounds"]) if n else None
