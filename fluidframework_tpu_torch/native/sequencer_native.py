"""ctypes binding for the native deli sequencer (``sequencer.cpp``).

A port of ``fluidframework_tpu/native/sequencer_native.py`` (no JAX in it).
Drop-in replacement for ``server.sequencer.Sequencer``: same public
surface (join/leave/ticket/mint_service/clients membership, checkpoint/
restore, seq/min_seq/log — ``clients()`` maps client id to short id rather
than full ClientEntry objects) and bit-identical sequencing decisions.  The
integer state machine runs in C++; message-object construction stays in
Python (it is not the hot part).

Build: the source is this package's own copy of the repository's
``native/sequencer.cpp``; g++ builds it into the package's ``_build/``
directory as ``libtpusequencer-<hash>.so`` (``native/gxx.py``) on the first
``native_available()`` or ``NativeSequencer()`` of a process, never at
import.  A failed build leaves ``native_available()`` false, and
``server.lambdas._make_sequencer`` then falls back to the Python
``Sequencer``, as the reference's does.
"""

from __future__ import annotations

import ctypes
import struct
import sys
import time
from pathlib import Path

from ..protocol.messages import MessageType, Nack, SequencedMessage, UnsequencedMessage
from . import gxx

SRC = Path(__file__).resolve().parent / "sequencer.cpp"

_NACK_REASONS = {
    1: "client not joined",
    2: "refSeq below MSN",
    3: "refSeq from the future",
    4: "clientSeq out of order",
}

_lib_cache: list = []


def library_path() -> Path:
    return gxx.library_path(SRC, "libtpusequencer")


def _load() -> ctypes.CDLL | None:
    """The library, built on the first call of the process when missing;
    None when it cannot be built or loaded."""
    if _lib_cache:
        return _lib_cache[0]
    path = library_path()
    if not path.exists():
        gxx.build(SRC, path, "native sequencer")
    lib = None
    if path.exists():
        try:
            lib = _bind(ctypes.CDLL(str(path)))
        except OSError as e:
            print(f"native sequencer: cannot load {path.name}: {e}", file=sys.stderr)
    _lib_cache[:] = [lib]
    return lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.seq_create.restype = ctypes.c_void_p
    lib.seq_create.argtypes = [ctypes.c_int64]
    lib.seq_destroy.argtypes = [ctypes.c_void_p]
    lib.seq_current.restype = ctypes.c_int64
    lib.seq_current.argtypes = [ctypes.c_void_p]
    lib.seq_min.restype = ctypes.c_int64
    lib.seq_min.argtypes = [ctypes.c_void_p]
    lib.seq_client_count.restype = ctypes.c_int32
    lib.seq_client_count.argtypes = [ctypes.c_void_p]
    lib.seq_join.restype = ctypes.c_int32
    lib.seq_join.argtypes = [ctypes.c_void_p, ctypes.c_char_p, i64p, i64p]
    lib.seq_leave.restype = ctypes.c_int32
    lib.seq_leave.argtypes = [ctypes.c_void_p, ctypes.c_char_p, i64p, i64p, i64p, i64p]
    lib.seq_ticket.restype = ctypes.c_int32
    lib.seq_ticket.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
        i64p, i64p, ctypes.POINTER(ctypes.c_int32),
    ]
    lib.seq_mint_service.restype = ctypes.c_int64
    lib.seq_mint_service.argtypes = [ctypes.c_void_p, i64p]
    lib.seq_checkpoint.restype = ctypes.c_int64
    lib.seq_checkpoint.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64
    ]
    lib.seq_restore.restype = ctypes.c_void_p
    lib.seq_restore.argtypes = [ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]
    return lib


def native_available() -> bool:
    return _load() is not None


class NativeSequencer:
    """C++-backed sequencer with the Python Sequencer's surface."""

    def __init__(self, starting_seq: int = 0, _handle=None) -> None:
        lib = _load()
        if lib is None:
            raise RuntimeError("native sequencer library unavailable")
        self._lib = lib
        self._h = _handle if _handle is not None else lib.seq_create(starting_seq)
        self.log: list[SequencedMessage] = []
        self._members: dict[str, int] = {}  # client id -> short id

    def __del__(self) -> None:
        h = getattr(self, "_h", None)
        if h:
            self._lib.seq_destroy(h)
            self._h = None

    # ------------------------------------------------------------------ admin
    @property
    def seq(self) -> int:
        return self._lib.seq_current(self._h)

    @property
    def min_seq(self) -> int:
        return self._lib.seq_min(self._h)

    def clients(self) -> dict[str, int]:
        """client id -> short id for currently joined clients."""
        assert len(self._members) == self._lib.seq_client_count(self._h)
        return dict(self._members)

    def __contains__(self, client_id: str) -> bool:
        return client_id in self._members

    # ------------------------------------------------------------------ joins
    def join(self, client_id: str) -> SequencedMessage:
        out_seq = ctypes.c_int64()
        out_min = ctypes.c_int64()
        short = self._lib.seq_join(
            self._h, client_id.encode(), ctypes.byref(out_seq), ctypes.byref(out_min)
        )
        if short < 0:
            raise ValueError(f"duplicate join: {client_id}")
        self._members[client_id] = short
        msg = SequencedMessage(
            client_id=client_id,
            client_seq=0,
            ref_seq=out_seq.value - 1,
            seq=out_seq.value,
            min_seq=out_min.value,
            type=MessageType.JOIN,
            contents={"clientId": client_id, "short": short},
            metadata=None,
            timestamp=time.time(),
            short_client=short,
        )
        self.log.append(msg)
        return msg

    def leave(self, client_id: str) -> SequencedMessage:
        out_seq = ctypes.c_int64()
        out_min = ctypes.c_int64()
        out_cseq = ctypes.c_int64()
        out_rseq = ctypes.c_int64()
        short = self._lib.seq_leave(
            self._h, client_id.encode(), ctypes.byref(out_seq), ctypes.byref(out_min),
            ctypes.byref(out_cseq), ctypes.byref(out_rseq),
        )
        if short < 0:
            raise ValueError(f"leave of unjoined client: {client_id}")
        self._members.pop(client_id, None)
        msg = SequencedMessage(
            client_id=client_id,
            client_seq=out_cseq.value,
            ref_seq=out_rseq.value,
            seq=out_seq.value,
            min_seq=out_min.value,
            type=MessageType.LEAVE,
            contents={"clientId": client_id},
            metadata=None,
            timestamp=time.time(),
            short_client=short,
        )
        self.log.append(msg)
        return msg

    # ----------------------------------------------------------------- ticket
    def ticket(self, msg: UnsequencedMessage) -> SequencedMessage | Nack:
        out_seq = ctypes.c_int64()
        out_min = ctypes.c_int64()
        out_short = ctypes.c_int32()
        rc = self._lib.seq_ticket(
            self._h, msg.client_id.encode(), msg.client_seq, msg.ref_seq,
            ctypes.byref(out_seq), ctypes.byref(out_min), ctypes.byref(out_short),
        )
        if rc != 0:
            return Nack(msg.client_id, msg.client_seq, _NACK_REASONS[rc])
        out = SequencedMessage(
            client_id=msg.client_id,
            client_seq=msg.client_seq,
            ref_seq=msg.ref_seq,
            seq=out_seq.value,
            min_seq=out_min.value,
            type=msg.type,
            contents=msg.contents,
            metadata=msg.metadata,
            timestamp=time.time(),
            short_client=out_short.value,
        )
        self.log.append(out)
        return out

    def mint_service(self, mtype: str, contents) -> SequencedMessage:
        out_min = ctypes.c_int64()
        seq = self._lib.seq_mint_service(self._h, ctypes.byref(out_min))
        # Scribe-driven MSN plumbing (mirror Sequencer.mint_service): a
        # summary ack carries the ack-derived compaction floor.  The floor
        # itself is Python-side state — the C++ core predates acks and its
        # checkpoint format must stay stable — so a restore conservatively
        # restarts the floor at 0 (compaction lags, never overruns).
        if mtype == MessageType.SUMMARY_ACK and isinstance(contents, dict):
            ref = contents.get("refSeq")
            if isinstance(ref, int):
                self._ack_floor = max(getattr(self, "_ack_floor", 0), ref)
            contents.setdefault(
                "msn", min(getattr(self, "_ack_floor", 0), out_min.value)
            )
        out = SequencedMessage(
            client_id="__service__",
            client_seq=0,
            ref_seq=seq - 1,
            seq=seq,
            min_seq=out_min.value,
            type=mtype,
            contents=contents,
            metadata=None,
            timestamp=time.time(),
            short_client=-1,
        )
        self.log.append(out)
        return out

    # ------------------------------------------------------------- checkpoint
    def checkpoint_bytes(self) -> bytes:
        n = self._lib.seq_checkpoint(self._h, None, 0)
        buf = (ctypes.c_uint8 * n)()
        self._lib.seq_checkpoint(self._h, buf, n)
        return bytes(buf)

    @staticmethod
    def restore_bytes(data: bytes) -> "NativeSequencer":
        lib = _load()
        if lib is None:
            raise RuntimeError("native sequencer library unavailable")
        buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
        h = lib.seq_restore(buf, len(data))
        if not h:
            raise ValueError("truncated or corrupt sequencer checkpoint")
        out = NativeSequencer(_handle=h)
        out._members = _parse_checkpoint_members(data)
        return out


def _parse_checkpoint_members(data: bytes) -> dict[str, int]:
    """Read the client table from the flat checkpoint layout (see
    seq_checkpoint in sequencer.cpp)."""
    off = 8 + 8 + 4  # seq, min_seq, next_short
    (n,) = struct.unpack_from("<i", data, off)
    off += 4
    members: dict[str, int] = {}
    for _ in range(n):
        short, _cseq, _rseq, slen = struct.unpack_from("<iqqi", data, off)
        off += 4 + 8 + 8 + 4
        name = data[off : off + slen].decode()
        off += slen
        members[name] = short
    return members
