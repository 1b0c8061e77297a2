"""ctypes binding for the native merge-tree megastep (``megastep.cpp``).

A port of ``fluidframework_tpu/native/megastep_native.py`` (no JAX in it).
The C++ loops apply a [K, D, B] op ring — and the zamboni compact — in
place over the SAME int32 state columns the fleet programs carry, byte
identical to ``ops.mergetree_kernel.apply_megastep`` and
``models.doc_batch_engine._fleet_compact_body`` (held to the reference's
lax programs by tests/test_torch_dispatch_backends.py).  The dispatch
plane built on top lives in ``parallel/native_plane.py``.

Build: the source is this package's own copy of the repository's
``native/megastep.cpp``; g++ builds it into the package's ``_build/``
directory as ``libtpumegastep-<hash>.so`` (``native/gxx.py``) — but ONLY
through ``warm()``/``available()``, which the plane calls at program-build
time (engine construction).  The serving-path entry points (``loaded``,
``megastep``, ``fleet_compact``) never spawn the compiler: they can run
under the engines' ``ckpt_lock``, where a g++ run would stall every
ingest contender for seconds.

A dispatch is three parts, each callable alone (``chip_smoke.py`` times
them): ``state_columns`` copies the state's leaves to writable host
columns (a copy out of the card for a card state), ``run_megastep`` /
``run_compact`` run the loops in place, and ``unpack_columns`` rebuilds
the state on its own device (a copy into the card)."""

from __future__ import annotations

import ctypes
import sys
from pathlib import Path

import numpy as np
import torch

from . import gxx

SRC = Path(__file__).resolve().parent / "megastep.cpp"

OP_FIELDS = 8
ABI_VERSION = 1

_lib_cache: list = []
_warmed: list = []

_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)

# Column table order — must match megastep.cpp's header comment.
_COL_ORDER = (
    "text", "text_end", "nseg", "seg_start", "seg_len", "ins_key",
    "ins_client", "seg_uid", "seg_obpre", "rem_keys", "rem_clients",
    "prop_keys", "prop_vals", "uid_next", "ob_key", "ob_client",
    "ob_start_uid", "ob_end_uid", "ob_start_side", "ob_end_side",
    "ob_ref_seq", "min_seq", "error",
)


def library_path() -> Path:
    return gxx.library_path(SRC, "libtpumegastep")


def warm() -> bool:
    """Build (when missing: the name carries the source's hash) and load
    the library, eagerly and idempotently.  The ONLY entry that runs g++:
    the native plane calls it while building its fleet programs (engine
    ``__init__``, outside any serving lock)."""
    if not _warmed:
        _warmed.append(True)
        path = library_path()
        if not path.exists():
            gxx.build(SRC, path, "native megastep")
        _lib_cache[:] = [_try_load(path)]
    return _ensure_built() is not None


def _ensure_built() -> ctypes.CDLL | None:
    """Serving-path accessor: the cached library, loading a PREBUILT .so
    on first touch — never compiling."""
    if not _lib_cache:
        path = library_path()
        _lib_cache[:] = [_try_load(path) if path.exists() else None]
    return _lib_cache[0]


def _try_load(path: Path) -> ctypes.CDLL | None:
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        print(f"native megastep: cannot load {path.name}: {e}", file=sys.stderr)
        return None
    lib.ms_abi_version.restype = ctypes.c_int32
    lib.ms_abi_version.argtypes = []
    lib.ms_megastep.restype = ctypes.c_int32
    lib.ms_megastep.argtypes = [_I64P, _I32P, _I32P, _I32P]
    lib.ms_compact.restype = ctypes.c_int32
    lib.ms_compact.argtypes = [_I64P, _I32P, _I32P]
    if lib.ms_abi_version() != ABI_VERSION:
        print(f"native megastep: {path.name} has ABI {lib.ms_abi_version()}, "
              f"want {ABI_VERSION}", file=sys.stderr)
        return None
    return lib


def available() -> bool:
    """Build-on-demand probe for host tools and tests (outside any serving
    lock).  Serving paths use ``loaded()`` instead."""
    return warm()


def loaded() -> bool:
    """Non-building availability probe (safe under the engines' locks)."""
    return _ensure_built() is not None


def _host_i32(x) -> np.ndarray:
    """A fresh, writable, C-contiguous int32 host copy of a tensor (on any
    device) or array: the caller's leaves are never mutated in place."""
    if isinstance(x, torch.Tensor):
        on_card = x.device.type != "cpu"
        x = x.detach().to("cpu", torch.int32).contiguous().numpy()
        if on_card:  # the copy out of the card is already fresh
            return x
    return np.array(x, dtype=np.int32, order="C", copy=True)


def state_columns(state) -> dict:
    """Copy a [D, ...] DocState's leaves (tensors on any device, or numpy)
    into writable, C-contiguous int32 host columns, tuple fields stacked on
    a leading axis: field name -> array."""
    cols: dict[str, np.ndarray] = {}
    for name in _COL_ORDER:
        v = getattr(state, name)
        if isinstance(v, tuple):
            if isinstance(v[0], torch.Tensor):
                v = torch.stack(v)
            else:
                v = np.stack([np.asarray(a) for a in v])
        cols[name] = _host_i32(v)
    return cols


def _addrs(cols: dict) -> np.ndarray:
    return np.array([cols[name].ctypes.data for name in _COL_ORDER], np.int64)


def _state_device(state) -> torch.device:
    leaf = state.nseg
    return leaf.device if isinstance(leaf, torch.Tensor) else torch.device("cpu")


def unpack_columns(state, cols: dict):
    """Rebuild a DocState from mutated columns as int32 tensors on the
    state's own device (stacked tuple fields re-split into per-slot views:
    zero copy on the CPU, one upload a field on a card)."""
    dev = _state_device(state)
    kw = {}
    for name in _COL_ORDER:
        t = torch.from_numpy(cols[name])
        if dev.type != "cpu":
            t = t.to(dev)
        kw[name] = tuple(t.unbind(0)) if isinstance(getattr(state, name), tuple) else t
    return state._replace(**kw)


def _dims(cols: dict, extra: tuple = ()) -> np.ndarray:
    D, T = cols["text"].shape
    S = cols["seg_len"].shape[-1]
    R = cols["rem_keys"].shape[0]
    P = cols["prop_keys"].shape[0]
    OB = cols["ob_key"].shape[-1]
    return np.array((D, T, S, R, P, OB) + extra, np.int32)


def _lib() -> ctypes.CDLL:
    lib = _ensure_built()
    if lib is None:
        raise RuntimeError("native megastep library unavailable (g++ build failed?)")
    return lib


def run_megastep(cols: dict, ops, payloads) -> None:
    """Apply a [K, D, B, 8] op ring (+ [K, D, B, L] payloads; tensors on
    any device, or numpy) to host columns in place."""
    lib = _lib()
    ops = _host_i32(ops)
    payloads = _host_i32(payloads)
    K, D, B, L = ops.shape[0], ops.shape[1], ops.shape[2], payloads.shape[-1]
    if ops.shape[-1] != OP_FIELDS or payloads.shape[:3] != (K, D, B):
        raise ValueError(f"ops {ops.shape} and payloads {payloads.shape} disagree")
    dims = _dims(cols, (K, B, L))
    if dims[0] != D:
        raise ValueError(f"a ring of {D} docs for a state of {dims[0]}")
    addrs = _addrs(cols)
    rc = lib.ms_megastep(addrs.ctypes.data_as(_I64P), dims.ctypes.data_as(_I32P),
                         ops.ctypes.data_as(_I32P), payloads.ctypes.data_as(_I32P))
    if rc != 0:
        raise RuntimeError(f"native megastep failed (rc={rc}): dims {dims}")


def run_compact(cols: dict, min_seqs) -> None:
    """set_min_seq + zamboni compact of every doc of host columns, in
    place."""
    lib = _lib()
    min_seqs = _host_i32(min_seqs)
    dims = _dims(cols)
    if min_seqs.shape != (dims[0],):
        raise ValueError(f"min_seqs {min_seqs.shape} for {dims[0]} docs")
    addrs = _addrs(cols)
    rc = lib.ms_compact(addrs.ctypes.data_as(_I64P), dims.ctypes.data_as(_I32P),
                        min_seqs.ctypes.data_as(_I32P))
    if rc != 0:
        raise RuntimeError(f"native compact failed (rc={rc}): dims {dims}")


def megastep(state, ops, payloads):
    """Apply a [K, D, B, 8] op ring (+ [K, D, B, L] payloads) to a
    [D, ...] DocState through the native loops; returns the stepped state
    on the state's own device.  Raises RuntimeError when the prebuilt
    library is unavailable (callers guard with ``loaded()``/``warm()``)."""
    cols = state_columns(state)
    run_megastep(cols, ops, payloads)
    return unpack_columns(state, cols)


def fleet_compact(state, min_seqs):
    """set_min_seq + zamboni compact for every doc (the native twin of
    ``models.doc_batch_engine._fleet_compact_body``)."""
    cols = state_columns(state)
    run_compact(cols, min_seqs)
    return unpack_columns(state, cols)
