"""Per-rank batches: port of ``nanodiloco_tpu/parallel/feed.py``.

Every rank computes the SAME global batch from the seed (``DilocoBatcher``
and ``ShardBatcher`` derive their order from it alone) and keeps the rows
of its own workers: no cross-rank traffic, and a rank's batch does not
depend on how many ranks there are. Without a process group the slice is
the whole batch.
"""

from __future__ import annotations

import numpy as np

from nanodiloco_tpu_torch.parallel.mesh import WorkerMesh


class BatchFeeder:
    """Slices this rank's workers out of stacked rounds [H, W, accum, B, S]
    (the worker axis is axis 1)."""

    def __init__(self, mesh: WorkerMesh):
        self.mesh = mesh

    def local_slices(self, global_shape: tuple[int, ...]) -> tuple[slice, ...]:
        """This rank's box of a global round: its worker rows, every other
        axis whole."""
        if global_shape[1] != self.mesh.num_workers:
            raise ValueError(f"batch worker axis is {global_shape[1]} but num_workers is "
                             f"{self.mesh.num_workers}")
        return (slice(None), slice(self.mesh.lo, self.mesh.hi)) + (slice(None),) * (
            len(global_shape) - 2)

    def __call__(self, array: np.ndarray) -> np.ndarray:
        """The local rows of ``array``, contiguous; the array itself
        without a process group."""
        if not self.mesh.distributed:
            return array
        return np.ascontiguousarray(array[self.local_slices(array.shape)])
