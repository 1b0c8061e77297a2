"""ctypes binding for the native wire-ingest encoder (``ingest.cpp``).

The port's copy of ``fluidframework_tpu/native/ingest_native.py``.  One
``NativeIngestEncoder`` per document: JSON-lines sequenced messages in,
kernel op rows out — the whole decode and encode (JSON parse, quorum
lookup, insert chunking, property interning) runs in C++.  ``tree_decode``
decodes tree edit messages into the mark-pool columns that
``dds/tree/mark_pool.pool_commit_from_native`` consumes.

This is host C++, not a device kernel: the source is this package's own
copy of the repo's ``native/ingest.cpp`` and builds with g++ into the
package's ``_build/`` directory, as ``libtpuingest-<hash>.so`` where the
hash covers the source, so an edited source never loads a stale library.
Only ``warm()`` runs the compiler; the engines call it from ``__init__``
with no lock held.  The serving accessors (``loaded``, ``tree_decode``,
``NativeIngestEncoder``) only load a built library: they run under the
engines' ``ckpt_lock``, where a compiler run would stall every ingest.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SRC = Path(__file__).resolve().parent / "ingest.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

OP_FIELDS = 8

_lib_cache: list = []
_warmed: list = []


def library_path() -> Path:
    """Build output keyed by the content hash of the source and flags."""
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libtpuingest-{h.hexdigest()[:16]}.so"


def _build(lib: Path) -> None:
    """One g++ run into a temporary file renamed into place, so processes
    building at once (test workers) never load a half-written library.  A failure
    prints the compiler's output on stderr."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            ["g++", *CXX_FLAGS, "-o", tmp, str(SRC)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            print(
                f"native ingest: g++ failed (exit {proc.returncode}):\n"
                f"{proc.stderr}",
                file=sys.stderr,
            )
            return
        os.replace(tmp, lib)
    except OSError as e:
        print(f"native ingest: g++ could not run: {e}", file=sys.stderr)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def warm() -> bool:
    """Build (when missing) and load the library, eagerly and idempotently.
    The only entry that runs g++: call it at process or engine startup,
    never from a serving path.  Returns whether the library loaded."""
    if _warmed:
        return bool(_lib_cache) and _lib_cache[0] is not None
    _warmed.append(True)
    lib = library_path()
    if not lib.exists():
        _build(lib)
    _lib_cache[:] = [_try_load(lib) if lib.exists() else None]
    return _lib_cache[0] is not None


def _ensure_built() -> ctypes.CDLL | None:
    """Serving-path accessor: the cached library, loading a built one on
    first touch — never compiling.  None when no built library exists (the
    callers fall back to the Python decode paths)."""
    if _lib_cache:
        return _lib_cache[0]
    lib = library_path()
    _lib_cache[:] = [_try_load(lib) if lib.exists() else None]
    return _lib_cache[0]


def _try_load(path: Path) -> ctypes.CDLL | None:
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        print(f"native ingest: cannot load {path.name}: {e}", file=sys.stderr)
        return None
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.ing_create.restype = ctypes.c_void_p
    lib.ing_create.argtypes = [ctypes.c_int32, ctypes.c_int32]
    lib.ing_destroy.argtypes = [ctypes.c_void_p]
    lib.ing_min_seq.restype = ctypes.c_int64
    lib.ing_min_seq.argtypes = [ctypes.c_void_p]
    lib.ing_last_error.restype = ctypes.c_char_p
    lib.ing_last_error.argtypes = [ctypes.c_void_p]
    lib.ing_encode.restype = ctypes.c_int32
    lib.ing_encode.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64, i32p, i32p,
        ctypes.c_int32,
    ]
    lib.ing_prop_table.restype = ctypes.c_int32
    lib.ing_prop_table.argtypes = [ctypes.c_void_p, i64p, i32p, ctypes.c_int32]
    lib.ing_tree_decode.restype = ctypes.c_int32
    lib.ing_tree_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        i64p, ctypes.c_int32, i32p, ctypes.c_int32,
        i32p, ctypes.c_int32, i32p, ctypes.c_int32,
        i64p, ctypes.c_int32, i32p, i32p,
    ]
    return lib


def available() -> bool:
    """Build-on-demand probe for tools and tests (outside any lock)."""
    return warm()


def loaded() -> bool:
    """Non-building probe for serving paths (safe under the engines'
    locks): True iff a built library is loaded or loadable."""
    return _ensure_built() is not None


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _i64p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


class NativeIngestEncoder:
    """Per-document native wire decoder (quorum and prop tables in C++)."""

    def __init__(self, max_insert_len: int = 64, prop_slots: int = 4) -> None:
        lib = _ensure_built()
        if lib is None:
            raise RuntimeError("native ingest encoder unavailable (g++ build failed)")
        self._lib = lib
        self.max_insert_len = max_insert_len
        self._h = lib.ing_create(max_insert_len, prop_slots)

    def __del__(self) -> None:
        if getattr(self, "_h", None):
            self._lib.ing_destroy(self._h)
            self._h = None

    @property
    def min_seq(self) -> int:
        return int(self._lib.ing_min_seq(self._h))

    def prop_table(self) -> dict[int, int]:
        """The C++ property interning table as ``{prop_id: kernel slot}``;
        the engine folds it into its host table before it checkpoints a
        native-mode doc, so records carry the real property ids."""
        cap = 16
        while True:
            props = np.empty((cap,), np.int64)
            slots = np.empty((cap,), np.int32)
            n = self._lib.ing_prop_table(self._h, _i64p(props), _i32p(slots), cap)
            if n < cap:
                return {int(props[i]): int(slots[i]) for i in range(n)}
            cap *= 2

    def encode(self, data: bytes, max_rows: int = 0) -> tuple[np.ndarray, np.ndarray]:
        """Newline-separated JSON messages -> (ops[M, 8], payloads[M, L])."""
        if max_rows <= 0:
            max_rows = max(16, 2 * (data.count(b"\n") + 1))
        while True:
            # np.empty is safe: the encoder writes every field of each row
            # it returns (payload rows are cleared before use).
            ops = np.empty((max_rows, OP_FIELDS), np.int32)
            payloads = np.empty((max_rows, self.max_insert_len), np.int32)
            n = self._lib.ing_encode(
                self._h, data, len(data), _i32p(ops), _i32p(payloads), max_rows,
            )
            if n == -1:
                raise ValueError(
                    f"native ingest: {self._lib.ing_last_error(self._h).decode()}"
                )
            if n < -1:  # capacity exhausted mid-stream: grow and re-run
                max_rows *= 2
                continue
            return ops[:n], payloads[:n]


# ---------------------------------------------------------------------------
# Tree wire decode
# ---------------------------------------------------------------------------

# Row widths (mirror ingest.cpp ing_tree_decode).
_TREE_MSG_FIELDS = 14
_TREE_CHG_FIELDS = 3
_TREE_FLD_FIELDS = 4
_TREE_MARK_FIELDS = 5

TREE_ST_EDITS, TREE_ST_SKIP, TREE_ST_OPAQUE = 0, 1, 2


def tree_decode_available() -> bool:
    return _ensure_built() is not None


def tree_decode(data: bytes):
    """Decode newline-separated sequenced tree messages into mark-pool
    columns (stateless; grow-and-retry like ``NativeIngestEncoder.encode``).

    Returns ``(msgs, chgs, flds, marks, spans)`` numpy tables (layouts in
    the C header comment of ``ing_tree_decode``), or ``None`` when the
    library is not built.  Raises ``ValueError`` on a malformed line."""
    lib = _ensure_built()
    if lib is None:
        return None
    n_lines = data.count(b"\n") + 1
    m_msgs = max(16, n_lines)
    m_chgs = m_flds = max(32, 2 * n_lines)
    m_marks = m_spans = max(64, 8 * n_lines)
    while True:
        msgs = np.empty((m_msgs, _TREE_MSG_FIELDS), np.int64)
        chgs = np.empty((m_chgs, _TREE_CHG_FIELDS), np.int32)
        flds = np.empty((m_flds, _TREE_FLD_FIELDS), np.int32)
        marks = np.empty((m_marks, _TREE_MARK_FIELDS), np.int32)
        spans = np.empty((m_spans, 2), np.int64)
        counts = np.zeros((5,), np.int32)
        err_line = np.zeros((1,), np.int32)
        n = lib.ing_tree_decode(
            data, len(data),
            _i64p(msgs), m_msgs, _i32p(chgs), m_chgs,
            _i32p(flds), m_flds, _i32p(marks), m_marks,
            _i64p(spans), m_spans, _i32p(counts), _i32p(err_line),
        )
        if n == -1:
            raise ValueError(
                f"native tree decode: malformed message at line {int(err_line[0])}"
            )
        if n == -2:  # some table filled: double everything, re-run
            m_msgs *= 2
            m_chgs *= 2
            m_flds *= 2
            m_marks *= 2
            m_spans *= 2
            continue
        return (
            msgs[: counts[0]], chgs[: counts[1]], flds[: counts[2]],
            marks[: counts[3]], spans[: counts[4]],
        )
