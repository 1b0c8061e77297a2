"""The g++ build of the port's host C++ libraries (``ingest.cpp``,
``sequencer.cpp``): one shared object per source in the package's
``_build/`` directory, named by the content hash of the source and flags,
so an edited source never loads a stale library."""

from __future__ import annotations

import hashlib
import os
import subprocess
import sys
import tempfile
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")


def library_path(src: Path, stem: str) -> Path:
    """``_build/<stem>-<hash>.so``, the hash over the source and flags."""
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"{stem}-{h.hexdigest()[:16]}.so"


def build(src: Path, lib: Path, what: str) -> None:
    """One g++ run into a temporary file renamed into place, so processes
    building at once (test workers) never load a half-written library.  A
    failure prints the compiler's output on stderr and leaves no library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            ["g++", *CXX_FLAGS, "-o", tmp, str(src)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            print(f"{what}: g++ failed (exit {proc.returncode}):\n{proc.stderr}",
                  file=sys.stderr)
            return
        os.replace(tmp, lib)
    except OSError as e:
        print(f"{what}: g++ could not run: {e}", file=sys.stderr)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
