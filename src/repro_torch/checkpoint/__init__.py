"""Round-indexed model storage (COS), in the reference's npz format."""
from repro_torch.checkpoint.store import ObjectStore

__all__ = ["ObjectStore"]
