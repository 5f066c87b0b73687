"""The port's train() with the async outer step under heterogeneous H and
the int4 wire, in streaming DiLoCo, and under the straggler policy against the JAX package's train() on the CPU at a tiny size: every record
at its step with JAX's keys (minus the unported subsystems'), the mode
keys exactly, the losses and the summary. The comparison and its
tolerances are tests/test_torch_train_options.py's; this file holds the
modes that do not fit that file's time.
"""

import pytest
import torch

from test_torch_train_options import check_mode_against_jax, run_both

MODES = {
    "async-hetero-int4": dict(async_outer=True, outer_delay=1, inner_steps_per_worker=(3, 1),
                              outer_comm_dtype="int4"),
    "streaming": dict(streaming_fragments=2, streaming_delay=1, merge_alpha=0.5),
    "straggler-bf16": dict(straggler_factor=2.0, inner_steps_per_worker=(3, 2),
                           outer_comm_dtype="bfloat16"),
}


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """The suite runs in several worker processes on one machine; one
    torch thread per worker, restored after this file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mode_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("modes")
    return {name: run_both(d, name, measure_comm=False, **kw) for name, kw in MODES.items()}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_mode_sync_records_match_jax(mode_runs, mode):
    check_mode_against_jax(mode_runs[mode], MODES[mode])
