"""The port stands alone: no module of `repro_torch`, and not the chip
smoke script, imports JAX or the reference package."""
import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)",
                       re.MULTILINE)
FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + \
    [REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_imports(path):
    hits = [m.group(0).strip() for m in FORBIDDEN.finditer(path.read_text())]
    assert not hits, f"{path.name} imports {hits}"


#: the streaming and serving slice: each module and the names it must
#: carry (the reference's, where the reference has them)
SLICE_MODULES = {
    "repro_torch.core.delta": ("EdgeDelta", "csr_lookup", "csr_diff",
                               "apply_delta"),
    "repro_torch.plan.fingerprint": ("delta_fingerprint",
                                     "chain_fingerprint",
                                     "forget_fingerprint"),
    "repro_torch.plan.cache": ("PlanCache", "compile_kwargs"),
    "repro_torch.plan.overlay": ("OverlaidPlan", "overlay",
                                 "overlay_eligible",
                                 "DEFAULT_STALENESS_BUDGET"),
    "repro_torch.graph.drivers": ("warm_start_params", "WARM_START_PARAM"),
    "repro_torch.serve_graph.requests": ("AnalyticRequest", "AnalyticResult",
                                         "GraphMutation", "MutationResult"),
    "repro_torch.serve_graph.admission": ("AdmissionController",),
    "repro_torch.serve_graph.scheduler": ("GraphScheduler",
                                          "RunningRequest"),
    "repro_torch.serve_graph.engine": ("GraphEngine", "GraphEngineConfig"),
}


@pytest.mark.parametrize("module", sorted(SLICE_MODULES))
def test_streaming_and_serving_modules(module):
    import importlib

    mod = importlib.import_module(module)
    missing = [n for n in SLICE_MODULES[module] if not hasattr(mod, n)]
    assert not missing, f"{module} lacks {missing}"
    assert (REPO / "src" / (module.replace(".", "/") + ".py")) in FILES


def test_port_imports_without_jax_loaded():
    """Importing every port module in a fresh interpreter loads neither
    jax nor repro."""
    import subprocess
    import sys

    code = ("import sys, importlib, pkgutil, repro_torch\n"
            "for m in pkgutil.walk_packages(repro_torch.__path__, "
            "'repro_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'repro.')) or m == 'repro']\n"
            "assert not bad, bad\n")
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"}
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)
