"""Time the scatter kernel's global-atomic branch of this checkout against
the same kernel of another checkout (the parent commit's single design, or
any tree with chip_smoke.py), on one CUDA card, in one call.

    python3 ab_scatter.py OTHER_TREE

runs OTHER_TREE, this tree, this tree, OTHER_TREE, each in a process of
its own that builds its tree's kernels, then times `lattice.scatter_step`
on configs 1 and 2 and the changelog query at chip_smoke's main-path
shapes (2^20 records): CUDA events over 100 back-to-back calls after 10
warm-up calls, ms a call. A tree whose `scatter_step` takes `mode` is run
in its global branch. Prints the card's name and power limit, then one
line per run: `AB <tree> {"config 1": ms, "config 2": ms,
"changelog": ms}`.
"""

from __future__ import annotations

import inspect
import json
import os
import subprocess
import sys


def _time_tree(tree: str) -> dict:
    sys.path.insert(0, tree)
    os.chdir(tree)
    import torch

    import chip_smoke as cs
    from hstream_tpu_torch.engine import expr as ex, lattice
    from hstream_tpu_torch.engine.kernels import build as kbuild

    kbuild.build()
    dev = torch.device("cuda", 0)
    kw = {}
    if "mode" in inspect.signature(lattice.scatter_step).parameters:
        from hstream_tpu_torch.engine.kernels import binding as kb
        kw = {"mode": kb.SCATTER_GLOBAL}

    def ms(fn, iters=100):
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / iters

    out = {}
    _, _, _, (key, ts, valid, cols) = cs.headline_batch(dev, cs.make_spec(1))
    for cfg, tsv in ((1, ts), (2, ts + 100_000)):
        spec = cs.make_spec(cfg)
        st = lattice.init_state(spec, dev)
        out[f"config {cfg}"] = ms(lambda: lattice.scatter_step(
            spec, st, -1, key, tsv, valid, cols, **kw))
    cspec, progs, (key, ts, valid, cols), _ = cs.changelog_batch(dev)
    cols, valid = dict(cols), valid.clone()
    ex.eval_programs(progs, cols, valid)
    st = lattice.init_state(cspec, dev)
    out["changelog"] = ms(lambda: lattice.scatter_step(
        cspec, st, -1, key, ts, valid, cols, **kw))
    return out


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--tree":
        print("AB", json.dumps(_time_tree(sys.argv[2])), flush=True)
        return 0
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    other = os.path.abspath(sys.argv[1])
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    for tree in (other, here, here, other):
        run = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--tree", tree], capture_output=True,
                             text=True)
        if run.returncode != 0:
            print(run.stdout + run.stderr, file=sys.stderr)
            return run.returncode
        line = [x for x in run.stdout.splitlines() if x.startswith("AB ")]
        print(f"AB {tree} {line[-1][3:]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
