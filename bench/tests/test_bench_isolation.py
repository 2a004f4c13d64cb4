"""Nothing the benchmark runs loads JAX or the JAX package, and the
plain reference loads nothing of the port. Modules are compared by
their top-level name whole: the port's name begins with the JAX
package's."""
import subprocess
import sys

import benchtest_util  # noqa: F401  (import paths)

# every module of the harness, the reference, the metric readers and
# the tools, imported in a fresh interpreter with the port's modules
# that the harness reaches at run time
HARNESS = r"""
import importlib, pkgutil, sys
from pathlib import Path
root = Path(sys.argv[1])
sys.path[:0] = [str(root), str(root / "src")]
import bench.harness, bench.reference, bench.drivers, bench.models
for pkg in (bench.harness, bench.reference, bench.drivers, bench.models):
    for m in pkgutil.iter_modules(pkg.__path__, pkg.__name__ + "."):
        importlib.import_module(m.name)
import bench.run, bench.tools.sweep, bench.tools.calibrate
from bench.harness import spec
bench_json = spec.load_benchmark(root)
for m in bench_json["per_layer"]:
    spec.reader(m["name"])
for name in ("repro_torch.core.service", "repro_torch.core.server",
             "repro_torch.core.trainer", "repro_torch.opt.search",
             "repro_torch.kernels.ops", "repro_torch.configs.costmodel",
             "repro_torch.ir.dataset", "repro_torch.core.tokenizer"):
    importlib.import_module(name)
from bench.harness import runner
print(" ".join(runner.forbidden_modules()) or "none")
"""

# the reference alone
REFERENCE = r"""
import importlib, pkgutil, sys
from pathlib import Path
root = Path(sys.argv[1])
sys.path[:0] = [str(root)]
import bench.reference
for m in pkgutil.iter_modules(bench.reference.__path__, "bench.reference."):
    importlib.import_module(m.name)
tops = sorted({m.split(".")[0] for m in sys.modules})
print(" ".join(tops))
"""


def _run(code):
    proc = subprocess.run([sys.executable, "-c", code,
                           str(benchtest_util.ROOT)],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout.split()


def test_harness_loads_no_jax_nor_the_jax_package():
    assert _run(HARNESS) == ["none"]


def test_reference_loads_nothing_of_the_port():
    tops = _run(REFERENCE)
    assert "repro_torch" not in tops
    assert not {"jax", "jaxlib", "flax", "repro"} & set(tops)


def test_forbidden_names_are_compared_whole():
    import types
    from bench.harness import runner
    fake = {"repro_torch_lookalike": types.ModuleType("x"),
            "jaxtyping_like": types.ModuleType("x")}
    sys.modules.update(fake)
    try:
        assert runner.forbidden_modules() == []
        sys.modules["repro.fake"] = types.ModuleType("repro.fake")
        assert runner.forbidden_modules() == ["repro"]
    finally:
        for k in [*fake, "repro.fake"]:
            sys.modules.pop(k, None)
