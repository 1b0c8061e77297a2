"""The port's boundaries: it imports without JAX or the JAX package, its
entry points refuse to fall back to the CPU, and the chip smoke script
refuses to run without a card."""

from __future__ import annotations

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent

_BLOCKER = textwrap.dedent(
    """
    import importlib.abc, pkgutil, sys

    BLOCKED = ("jax", "jaxlib", "fluidframework_tpu")

    class Blocker(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if any(name == b or name.startswith(b + ".") for b in BLOCKED):
                raise ImportError(f"blocked import: {name}")
            return None

    sys.meta_path.insert(0, Blocker())
    import fluidframework_tpu_torch
    names = [m.name for m in pkgutil.walk_packages(
        fluidframework_tpu_torch.__path__, "fluidframework_tpu_torch.")]
    for name in names:
        __import__(name)
    import chip_smoke
    leaked = sorted(m for m in sys.modules
                    if any(m == b or m.startswith(b + ".") for b in BLOCKED))
    assert not leaked, leaked
    print(len(names))
    """
)


def test_port_imports_without_jax_or_the_jax_package():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKER], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 35  # every module of the port was imported


def test_blocker_blocks_the_jax_package():
    """The prefix check blocks ``fluidframework_tpu`` itself (so the test
    above proves something) without blocking ``fluidframework_tpu_torch``."""
    script = _BLOCKER.split("import fluidframework_tpu_torch")[0] + (
        "import fluidframework_tpu_torch\n"
        "try:\n    import fluidframework_tpu.protocol.stamps\nexcept ImportError:\n"
        "    print('blocked')\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", script], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT)),
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "blocked"


def test_entry_points_refuse_a_silent_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device is usable")
    from fluidframework_tpu_torch.parallel import mesh

    for call in (lambda: mesh.doc_mesh(), lambda: mesh.docs_segs_mesh()):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_chip_smoke_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0 and '"ok"' not in proc.stdout
    # Alone in a directory, without the port beside it.
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    proc = subprocess.run(
        [sys.executable, str(lone)], cwd=tmp_path,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0 and '"ok"' not in proc.stdout
