"""The PyTorch port stands alone: it imports neither JAX nor the
reference package, and its entry points refuse to fall back to the CPU."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

# Imports every module of the port with jax, jaxlib and the reference
# package refused by a meta-path hook; prints how many it imported.
BLOCKED_IMPORT = r"""
import importlib, importlib.abc, pkgutil, sys

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError(f"refused import of {name}")
        return None

sys.meta_path.insert(0, Refuse())
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
print(len(names))
"""

FORBIDDEN = [
    re.compile(r"^\s*(import|from)\s+(jax|jaxlib)\b", re.M),
    re.compile(r"^\s*from\s+repro(\.|\s)", re.M),
    re.compile(r"^\s*import\s+repro(\.|\s|,|$)", re.M),
    re.compile(r"\bjax\b"),
    re.compile(r"\brepro\.(core|ir|kernels|configs|data|opt|models)\b"),
    # the serving tier and obs copies: a module path, not the JSONL
    # schema's name "repro.obs/v1", which both packages write
    re.compile(r"\brepro\.(serving|obs|launch)(\.|\s|$)", re.M),
    re.compile(r"XLA_FLAGS"),
]


def test_port_imports_with_jax_and_reference_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", BLOCKED_IMPORT],
                          capture_output=True, text=True, env=env,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    # every module imported, the serving tier's and obs's among them
    assert int(proc.stdout.split()[-1]) >= 51


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")]
    + [str(p.relative_to(ROOT)) for p in PORT.rglob("*.cu")]
    + ["chip_smoke.py"]))
def test_source_mentions_neither_jax_nor_reference(path):
    text = (ROOT / path).read_text()
    for pat in FORBIDDEN:
        m = pat.search(text)
        assert m is None, f"{path}: {m.group(0)!r}"


def test_service_defaults_to_the_card():
    """device=None means "cuda"; without a card construction raises
    instead of silently running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    from repro_torch import params as P
    from repro_torch.configs.costmodel import COSTMODEL_SMALL
    from repro_torch.core import tokenizer as TOK
    from repro_torch.core.models import DEFAULT_HEADS
    from repro_torch.core.service import CostModelService
    stats = {t: {"mu": 0.0, "sigma": 1.0} for t in DEFAULT_HEADS}
    vocab = TOK.fit_vocab([["a", "b"]], max_size=16)
    for kind, init in (("conv1d", P.conv_init), ("lstm", P.lstm_init)):
        params = init(COSTMODEL_SMALL, DEFAULT_HEADS,
                      generator=torch.Generator().manual_seed(0))
        for kw in ({}, {"device": None}, {"device": "cuda"},
                   {"use_kernel": True}):
            with pytest.raises(RuntimeError, match="cuda.is_available"):
                CostModelService(kind, COSTMODEL_SMALL, params, vocab,
                                 stats, **kw)


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """chip_smoke.py exits non-zero and prints no result line without a
    card, and alone in a directory without the repository."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    for script in (ROOT / "chip_smoke.py", alone):
        proc = subprocess.run([sys.executable, str(script)],
                              capture_output=True, text=True,
                              cwd=script.parent, timeout=300)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
