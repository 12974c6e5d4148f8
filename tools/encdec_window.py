#!/usr/bin/env python3
"""Run `chip_smoke.py`'s lm_encdec phase (Whisper-large-v3 uncut) several
times on one card: each run prints the phase's lines, its `encdec trace`
window among them (a step's device ms, kernels a step, the paged
kernel's records), and the window's device ms beside the roofline floor
of that decode step.

    python3 tools/encdec_window.py [--runs 2]

from the root of a checkout.  Exits 1 if any of the phase's checks
failed.
"""
import argparse
import os
import sys
import time
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

#: the Whisper decode step's floor bytes over 3.35 TB/s (the smoke's
#: `roofline encdec decode` line)
FLOOR_MS = 1_811_491_872 / 3.35e12 * 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("encdec_window: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch import kernels as K
    from repro_torch.kernels import _build
    print(f"build_s {_build.build_all():.1f}", flush=True)
    dev = torch.device("cuda", 0)
    phase_args = types.SimpleNamespace(cpu_rehearsal=False, reps=50)
    for i in range(args.runs):
        t0 = time.perf_counter()
        cs.run_lm_encdec(phase_args, dev, K, {}, {})
        ms = cs.STEP_MS["encdec decode"]
        print(f"run {i}: encdec device_ms={ms:.3f} floor_ms={FLOOR_MS:.3f} "
              f"share={FLOOR_MS / ms:.3f} phase_s="
              f"{time.perf_counter() - t0:.1f} failures={cs.FAILURES}",
              flush=True)
        torch.cuda.empty_cache()
    return 1 if cs.FAILURES else 0


if __name__ == "__main__":
    sys.exit(main())
