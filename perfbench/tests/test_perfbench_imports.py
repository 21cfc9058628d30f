"""Nothing the harness or the reference imports is JAX or the JAX package,
compared by whole top-level names, and the reference imports nothing of
the program."""

import ast
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from perfbench.run import FORBIDDEN, forbidden_modules  # noqa: E402

PERFBENCH = ROOT / "perfbench"


def _imports(path: Path) -> set[str]:
    """Top-level names of every module ``path`` imports."""
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_no_jax_in_the_harness():
    files = sorted(PERFBENCH.rglob("*.py"))
    assert files
    for f in files:
        bad = _imports(f) & set(FORBIDDEN)
        assert not bad, f"{f.relative_to(ROOT)} imports {bad}"


def _modules(path: Path) -> set[str]:
    """Full names of every module ``path`` imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def test_reference_imports_nothing_of_the_program():
    """torch and the standard library, and within the benchmark only the
    reference itself."""
    for f in sorted((PERFBENCH / "reference").rglob("*.py")):
        tops = _imports(f)
        assert "basi_tpu_torch" not in tops, f
        assert tops <= {"__future__", "contextlib", "math", "torch",
                        "perfbench"}, (f, tops)
        ours = {m for m in _modules(f) if m.split(".")[0] == "perfbench"}
        assert all(m.startswith("perfbench.reference") for m in ours), (f, ours)


def test_forbidden_names_compare_whole():
    sys.modules.setdefault("basi_tpu_torch", __import__("basi_tpu_torch"))
    assert "basi_tpu_torch" not in forbidden_modules()
    assert "basi_tpu" in FORBIDDEN


def test_the_run_loads_no_jax():
    """The training driver, the reference and the program imported in a
    fresh process leave no forbidden module loaded."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from perfbench.harness.manifest import load_cell, load_driver\n"
            "from perfbench.run import forbidden_modules\n"
            "cell = load_cell(%r, 'roi_train_b64')\n"
            "load_driver(cell)\n"
            "import basi_tpu_torch.train.loop, perfbench.calibrate\n"
            "print(forbidden_modules())\n") % (str(ROOT), str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_without_a_card_no_result(tmp_path):
    """No CUDA device: exit code 2, nothing on standard output."""
    out = subprocess.run(
        [sys.executable, str(PERFBENCH / "run.py"), "--workload",
         "roi_train_b64", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
             "HOME": str(tmp_path)})
    assert out.returncode != 0
    assert out.stdout == ""
