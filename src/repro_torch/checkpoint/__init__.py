"""Round-indexed model storage (COS), in the reference's npz format, and
the wire server's durable run directory (`DurableRun`)."""
from repro_torch.checkpoint.store import ObjectStore

__all__ = ["ObjectStore", "DurableRun"]


def __getattr__(name):
    # durable imports the transport stack (and through it the engine and
    # the models); keep the plain ObjectStore import light
    if name == "DurableRun":
        from repro_torch.checkpoint.durable import DurableRun

        return DurableRun
    raise AttributeError(name)
