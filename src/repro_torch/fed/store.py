"""Per-client row state (``repro.fed.store``): so far only ``_LazyRows``,
the pinned FedGroup trainer's cache of eq.-9 update directions, which the
shift detector reads. The reference's streamed client store and its
state table are not yet ported (``ROADMAP.md``).
"""
from __future__ import annotations

import numpy as np
import torch


class _LazyRows:
    """(N, d) row table materialised per touched row: a shared default row
    plus an id -> row dict (memory ∝ clients touched). Rows live on the
    default row's device; ids are bookkept on the host."""

    def __init__(self, default_row: torch.Tensor):
        self.default_row = default_row.detach().float()
        self.rows = {}

    def gather(self, idx) -> torch.Tensor:
        """(len(idx), d) rows, the default where none was scattered."""
        idx = np.asarray(idx).ravel()
        if len(idx) == 0:
            return self.default_row.new_zeros((0,) + self.default_row.shape)
        return torch.stack([self.rows.get(int(i), self.default_row)
                            for i in idx])

    def scatter(self, idx, rows):
        rows = torch.as_tensor(rows, dtype=torch.float32,
                               device=self.default_row.device)
        for r, i in enumerate(np.asarray(idx).ravel()):
            self.rows[int(i)] = rows[r].clone()

    def delete(self, idx):
        """Drop materialised rows (untouched ids are a no-op) — the shift
        detector's cache invalidation: a deleted row reads back as the
        default until the next scatter."""
        for i in np.asarray(idx).ravel():
            self.rows.pop(int(i), None)

    def has(self, idx) -> np.ndarray:
        """(len(idx),) bool: which ids have a materialised row."""
        return np.array([int(i) in self.rows for i in np.asarray(idx)],
                        bool)

    def __len__(self):
        return len(self.rows)

    # -- checkpointing ------------------------------------------------------
    def ckpt_arrays(self) -> dict:
        """Dense numpy snapshot {ids (sorted), rows, default}."""
        ids = np.sort(np.fromiter(self.rows.keys(), np.int64, len(self.rows)))
        rows = (torch.stack([self.rows[int(i)] for i in ids]).cpu().numpy()
                if len(ids) else
                np.zeros((0,) + tuple(self.default_row.shape), np.float32))
        return {"ids": ids, "rows": rows,
                "default": self.default_row.cpu().numpy()}

    @classmethod
    def from_ckpt(cls, arrays: dict) -> "_LazyRows":
        table = cls(torch.as_tensor(np.asarray(arrays["default"],
                                               np.float32)))
        table.scatter(arrays["ids"], np.asarray(arrays["rows"], np.float32))
        return table
