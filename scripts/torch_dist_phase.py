"""Run ``chip_smoke.py``'s dist phase, parts (a)-(d), for one checkout and
print its part (c) times: the build, the train phase (the reference the
ranks are held to), then the dist phase without part (e). To compare two
checkouts on one card, run it for each in turns in one call, e.g. with
the parent unpacked into ``runs/parent``:

    for t in runs/parent . . runs/parent; do python3 scripts/torch_dist_phase.py $t; done

Each run prints the phase's own JSON lines on stderr and, on stdout, one
line with part (c)'s t_sync, round seconds, ranks' seconds and wire rate,
then one with the phase's seconds.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import shutil
import sys
import tempfile
import time
from contextlib import redirect_stdout
from pathlib import Path


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("checkout", nargs="?", default=str(Path(__file__).resolve().parents[1]),
                   help="root of the checkout whose chip_smoke.py runs")
    a = p.parse_args(argv)
    root = Path(a.checkout).resolve()
    os.chdir(root)
    sys.path.insert(0, str(root))
    import torch

    import chip_smoke as cs

    t0 = time.time()
    with redirect_stdout(sys.stderr):
        smi = cs.nvidia_smi()
        cs.build.build_all()
        summary = cs.phase_train(smi)
        work = Path(tempfile.mkdtemp(prefix="dist_phase_", dir=cs.MEM_PARENT))
        ref = cs.dist_reference(summary, work)
        del summary
        gc.collect()
        torch.cuda.empty_cache()
        if hasattr(cs, "phase_dist_shard"):  # part (e) is not timed here
            cs.phase_dist_shard = lambda work, smi: []
        lines = []
        emit = cs.emit
        cs.emit = lambda **kw: (lines.append(kw), emit(**kw))
        t1 = time.time()
        try:
            cs.phase_dist(ref, work, smi)
        finally:
            shutil.rmtree(work, ignore_errors=True)
    c = next(x for x in lines if x.get("part") == "c")
    print(json.dumps({k: c[k] for k in ("t_sync_s", "round_seconds", "ranks_seconds",
                                        "wire_gb_per_s")}))
    print(json.dumps({"checkout": str(root), "dist_s": time.time() - t1,
                      "total_s": time.time() - t0}), flush=True)


if __name__ == "__main__":
    main()
