"""The port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package ``repro``."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _forbidden_imports(source: str) -> list[str]:
    """Absolute imports of a forbidden top-level package, as
    ``"<line> <module>"``."""
    bad = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and not node.level:
            names = [node.module or ""]
        else:
            continue        # relative imports stay inside the package
        bad += [f"{node.lineno} {n}" for n in names
                if n.split(".")[0] in FORBIDDEN]
    return bad


def test_port_files_exist():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    for want in ("src/repro_torch/core/blco.py",
                 "src/repro_torch/core/mttkrp.py",
                 "src/repro_torch/kernels/fused.py",
                 "src/repro_torch/engine/plans.py",
                 "src/repro_torch/core/embed_grad.py",
                 "src/repro_torch/configs/base.py",
                 "src/repro_torch/models/transformer.py",
                 "src/repro_torch/serving/decode.py",
                 "src/repro_torch/examples/serve_lm.py",
                 "src/repro_torch/optim/adamw.py",
                 "src/repro_torch/train/trainer.py",
                 "src/repro_torch/launch/steps.py",
                 "src/repro_torch/dist/tensor_parallel.py",
                 "src/repro_torch/examples/train_lm.py", "chip_smoke.py"):
        assert want in names


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[p.relative_to(ROOT).as_posix()
                              for p in PORT_FILES])
def test_no_jax_or_repro_imports(path):
    assert _forbidden_imports(path.read_text()) == []


def test_checker_catches_forbidden_imports():
    src = ("import jax.numpy as jnp\nfrom repro.core import blco\n"
           "import repro\nfrom repro_torch.core import blco\n"
           "from . import sibling\nimport torch, jaxlib\n"
           "def f():\n    from jax import numpy\n")
    assert _forbidden_imports(src) == ["1 jax.numpy", "2 repro.core",
                                       "3 repro", "6 jaxlib", "8 jax"]


# the port's side of a test that holds the port against the reference in
# subprocesses: the code each port process runs, by its variable's name
PORT_SIDES = {"tests/test_torch_tensor_parallel.py": ("_RANK_CODE",
                                                      "_FLOPS_CODE")}


@pytest.mark.parametrize("path,name", [(p, n) for p, names in
                                       PORT_SIDES.items() for n in names])
def test_port_side_of_a_test_imports_no_jax(path, name):
    tree = ast.parse((ROOT / path).read_text())
    code = [node.value.value for node in tree.body
            if isinstance(node, ast.Assign)
            and any(getattr(t, "id", None) == name for t in node.targets)]
    assert len(code) == 1, name
    assert "repro_torch" in code[0]
    assert _forbidden_imports(code[0]) == []
