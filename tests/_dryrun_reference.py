"""The reference's side of the dry-run memory test: run as a subprocess
(the XLA device count is fixed at JAX's first import),

    python tests/_dryrun_reference.py ARCH BATCH SEQ

it builds the train, prefill and decode plans of ARCH's reduced config
at BATCH x SEQ on a (data 2, model 4) mesh of eight host devices,
compiles them and prints `memory_analysis()`'s argument and alias bytes
as one JSON line {kind: [argument, alias]}.
"""
import json
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"

from repro.configs import get_config  # noqa: E402
from repro.configs.base import ShapeConfig  # noqa: E402
from repro.launch.mesh import make_mesh  # noqa: E402
from repro.launch.steps import build_plan  # noqa: E402


def main(arch, batch, seq):
    cfg = get_config(arch).reduced()
    mesh = make_mesh((2, 4), ("data", "model"))
    out = {}
    for kind in ("train", "prefill", "decode"):
        plan = build_plan(cfg, ShapeConfig("t", seq, batch, kind), mesh)
        ma = plan.lower(mesh).compile().memory_analysis()
        out[kind] = [int(ma.argument_size_in_bytes),
                     int(ma.alias_size_in_bytes)]
    print(json.dumps(out))


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
