"""Host cost of one training step of the torch port, on the CPU.

Builds chip_smoke.py's bench scene at a small size on the CPU and counts,
for one forward + backward of ``render`` (chip_smoke's phase 8 step), the
Python function calls (cProfile) and the aten ops (torch.profiler), then
times 20 steps. The counts do not depend on the machine, so two trees can
be compared here: the step's host work on the card is the same work.

    python3 host_cost.py [ROOT]

ROOT is the root of the checkout to import (default: this file's
directory); run it once per tree, e.g. on a ``git archive`` of the parent
unpacked into a gitignored directory.
"""

from __future__ import annotations

import cProfile
import os
import pstats
import sys
import time

ROOT = os.path.abspath(sys.argv[1] if len(sys.argv) > 1
                       else os.path.dirname(__file__))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

SCENE = dict(n=3000, width=160, height=96)
STEPS = 20


def main() -> int:
    torch.set_num_threads(1)
    cs.FULL.update(SCENE)
    _, _, cam, args, kw = cs.bench_scene(torch.device("cpu"))
    x = cs.leaves(args)

    def step():
        res = cs.render(*x[:4], cam, sh=x[4], sh_deg=3, **kw)
        return torch.autograd.grad(torch.mean(res.image ** 2), x)

    for _ in range(3):
        step()
    prof = cProfile.Profile()
    prof.enable()
    step()
    prof.disable()
    calls = pstats.Stats(prof).total_calls
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as tp:
        step()
    ops = sum(e.count for e in tp.key_averages()
              if e.key.startswith("aten::"))
    t0 = time.perf_counter()
    for _ in range(STEPS):
        step()
    ms = (time.perf_counter() - t0) / STEPS * 1e3
    print(f"{ROOT}: {SCENE['n']} gaussians {SCENE['width']}x"
          f"{SCENE['height']}: {calls} Python calls and {ops} aten ops per "
          f"training step, {ms:.2f} ms per step on the CPU")
    return 0


if __name__ == "__main__":
    sys.exit(main())
