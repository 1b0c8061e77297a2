"""What the benchmark may import, checked on whole top-level module names:
``fluidframework_tpu_torch`` begins with ``fluidframework_tpu``, so a
prefix test would be wrong."""

import ast
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "fluidframework_tpu"}


def _tops(path: Path) -> set[str]:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops.update(a.name.split(".", 1)[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".", 1)[0])
    return tops


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(HERE.rglob("*.py"))
    assert len(files) > 10
    for f in files:
        bad = _tops(f) & FORBIDDEN
        assert not bad, f"{f.relative_to(HERE)} imports {bad}"


def test_reference_imports_nothing_of_the_program():
    for f in sorted((HERE / "reference").rglob("*.py")):
        tops = _tops(f)
        assert "fluidframework_tpu_torch" not in tops, f
        assert tops <= {"__future__", "json", "numpy"}, (f, tops)


def test_whole_word_comparison():
    src = "import fluidframework_tpu_torch.models\nfrom fluidframework_tpu.dds import x\n"
    p = HERE / ".out" / "probe_imports.py"
    p.parent.mkdir(exist_ok=True)
    p.write_text(src)
    try:
        assert _tops(p) & FORBIDDEN == {"fluidframework_tpu"}
    finally:
        p.unlink()


def test_forbidden_modules_by_whole_name(monkeypatch):
    import sys

    from fleetbench import harness

    monkeypatch.setitem(sys.modules, "fluidframework_tpu_torch_probe", object())
    assert "fluidframework_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "fluidframework_tpu.probe", object())
    assert "fluidframework_tpu" in harness.forbidden_modules()
