"""round_state_gib: bytes of every tensor of the program's round state
(params, optimizer moments, aggregator state), read from the server."""


def read(rec: dict):
    return rec["state_bytes"] / 2**30 if rec.get("state_bytes") else None
