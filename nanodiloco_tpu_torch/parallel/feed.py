"""Per-rank batches: port of ``nanodiloco_tpu/parallel/feed.py``.

Every rank computes the SAME global batch from the seed (``DilocoBatcher``
and ``ShardBatcher`` derive their order from it alone) and keeps its box
of it, ``parallel/sharding.py::BATCH_SPEC``: its worker group's rows of
the worker axis and, of each worker's microbatch rows, its fsdp index's
``B / fsdp`` (the tp ranks of one worker read the same rows). No
cross-rank traffic, and a rank's batch does not depend on how many ranks
there are. Without a process group the box is the whole batch.
"""

from __future__ import annotations

import numpy as np

from nanodiloco_tpu_torch.parallel.mesh import WorkerMesh
from nanodiloco_tpu_torch.parallel.sharding import BATCH_SPEC, local_box


class BatchFeeder:
    """Slices this rank's box out of stacked rounds [H, W, accum, B, S]
    (the worker axis is axis 1, the rows axis 3)."""

    def __init__(self, mesh: WorkerMesh):
        self.mesh = mesh

    def local_slices(self, global_shape: tuple[int, ...]) -> tuple[slice, ...]:
        """This rank's box of a global round: its worker rows and its fsdp
        index's microbatch rows, every other axis whole."""
        if global_shape[1] != self.mesh.num_workers:
            raise ValueError(f"batch worker axis is {global_shape[1]} but num_workers is "
                             f"{self.mesh.num_workers}")
        self.mesh.check_batch(global_shape[3])
        return local_box((None,) + BATCH_SPEC, global_shape, self.mesh)

    def __call__(self, array: np.ndarray) -> np.ndarray:
        """The local rows of ``array``, contiguous; the array itself
        without a process group."""
        if not self.mesh.distributed:
            return array
        return np.ascontiguousarray(array[self.local_slices(array.shape)])
