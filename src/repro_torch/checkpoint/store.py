"""Cloud Object Storage (COS): round-indexed model storage (port of
``repro/checkpoint/store.py``).

Same on-disk format as the reference: each PUT writes an immutable
``np.savez_compressed`` blob keyed by SHA-256 and records (task, round) ->
key in a JSON manifest. The npz keys are the reference's param paths
(``stem``, ``stages/0/down``, ``heads/2``) and the weights are stored in
its HWIO layout (``models.convert``), so a round checkpointed by either
package restores in the other. GC keeps the newest ``keep`` rounds per task.
"""
from __future__ import annotations

import hashlib
import io
import json
import os
from pathlib import Path

import numpy as np
from torch import nn

from repro_torch.models import convert
from repro_torch.models.params import flatten_with_paths


class ObjectStore:
    def __init__(self, root: str | Path):
        self.root = Path(root)
        (self.root / "objects").mkdir(parents=True, exist_ok=True)
        self.manifest_path = self.root / "manifest.json"
        self.manifest: dict = (
            json.loads(self.manifest_path.read_text()) if self.manifest_path.exists() else {}
        )

    def _save_manifest(self) -> None:
        # atomic tmp+fsync+rename: a crash mid-write must never leave a
        # half-written manifest.json bricking every subsequent restore
        tmp = self.manifest_path.with_suffix(".json.tmp")
        with open(tmp, "w") as f:
            f.write(json.dumps(self.manifest, indent=1, sort_keys=True))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.manifest_path)

    def put_model(self, task_id: str, round_idx: int, model, meta: dict | None = None) -> str:
        """Store a model under its param paths: a :class:`FedYOLOv3` module's
        weights in the reference's HWIO layout (``stages/0/down``), an LM's
        param tree as it is (``layers/attn/wq``)."""
        if isinstance(model, nn.Module):
            arrays = dict(flatten_with_paths(convert.to_reference(model)))
        else:
            arrays = dict(flatten_with_paths(convert.lm_params_to_reference(model)))
        buf = io.BytesIO()
        np.savez_compressed(buf, **arrays)
        blob = buf.getvalue()
        key = hashlib.sha256(blob).hexdigest()
        obj = self.root / "objects" / key
        if not obj.exists():
            obj.write_bytes(blob)
        self.manifest.setdefault(task_id, {})[str(round_idx)] = {
            "key": key,
            "bytes": len(blob),
            **(meta or {}),
        }
        self._save_manifest()
        return key

    def get_model(self, task_id: str, round_idx: int | None = None) -> dict[str, np.ndarray]:
        if task_id not in self.manifest or not self.manifest[task_id]:
            raise KeyError(
                f"no stored model for task {task_id!r}; stored tasks: "
                f"{sorted(self.manifest) or 'none'}"
            )
        rounds = self.manifest[task_id]
        r = str(max(int(k) for k in rounds) if round_idx is None else round_idx)
        if r not in rounds:
            raise KeyError(
                f"task {task_id!r} has no round {r}; available rounds: "
                f"{self.rounds(task_id)}"
            )
        key = rounds[r]["key"]
        with np.load(self.root / "objects" / key) as z:
            return {k: z[k] for k in z.files}

    def restore_into(self, task_id: str, model: nn.Module, round_idx: int | None = None) -> nn.Module:
        """Load a stored model (written by either package) into ``model`` in
        place and return it. ``load_state_dict`` refuses a missing or extra
        key and a shape mismatch."""
        model.load_state_dict(convert.from_reference(self.get_model(task_id, round_idx)))
        return model

    def rounds(self, task_id: str) -> list[int]:
        return sorted(int(k) for k in self.manifest.get(task_id, {}))

    def total_bytes(self) -> int:
        return sum(f.stat().st_size for f in (self.root / "objects").iterdir())

    def gc(self, keep: int = 3) -> int:
        """Keep newest `keep` rounds per task; drop unreferenced blobs."""
        for task_id, rounds in self.manifest.items():
            for r in sorted((int(k) for k in rounds), reverse=True)[keep:]:
                del rounds[str(r)]
        live = {e["key"] for rs in self.manifest.values() for e in rs.values()}
        removed = 0
        for f in (self.root / "objects").iterdir():
            if f.name not in live:
                f.unlink()
                removed += 1
        self._save_manifest()
        return removed
