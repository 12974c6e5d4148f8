"""The reference's side of the per-rank dry-run test: run as a
subprocess (the XLA device count is fixed at JAX's first import),

    python tests/_dryrun_ranks_reference.py BATCH SEQ ARCH...

For each arch's reduced config, mesh (data 2, model 4) and (data 4,
model 2) of eight host devices and step kind, it compiles
`repro.launch.steps.build_plan` at BATCH x SEQ and prints, as one JSON
line, the per-device module's dot rows (`hlo_costs.top_ops`: FLOPs with
the trip multiplier, and the op's metadata tag) under "ARCH|DxM|KIND".
"""
import json
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"

from repro.configs import get_config  # noqa: E402
from repro.configs.base import ShapeConfig  # noqa: E402
from repro.launch.mesh import make_mesh  # noqa: E402
from repro.launch.steps import build_plan  # noqa: E402
from repro.roofline import hlo_costs  # noqa: E402


def main(batch, seq, archs):
    out = {}
    for arch in archs:
        cfg = get_config(arch).reduced()
        for shape in ((2, 4), (4, 2)):
            mesh = make_mesh(shape, ("data", "model"))
            for kind in ("train", "prefill", "decode"):
                plan = build_plan(cfg, ShapeConfig("t", seq, batch, kind),
                                  mesh)
                hlo = plan.lower(mesh).compile().as_text()
                out[f"{arch}|{shape[0]}x{shape[1]}|{kind}"] = [
                    [r[0], r[4]] for r in hlo_costs.top_ops(
                        hlo, by="flops", k=10 ** 9) if r[1] == "dot"]
    print(json.dumps(out))


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3:])
