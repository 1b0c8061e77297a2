"""Device-side rebase window dispatch for the EditManager fold.

The port's copy of ``fluidframework_tpu/dds/tree/device_rebase.py``: the
pooled fold (``mark_pool.rebase_pair``) walks each window entry with Python
column passes; this module moves the whole window onto K9
(``ops/rebase_kernel.py``, the hand CUDA kernel on the card, its plain
PyTorch form on the CPU).  The division of labour:

* ``encode_commit`` walks one pooled single-change Commit into the kernel's
  encoding — interior [Skip(p), Modify] levels as (field, pos) pairs, the
  leaf as padded mark columns with source-index handles into the commit's
  own span — packed once into the kernel's 76-word row.  Anything the
  columns cannot express (multi-change commits, constraints, moves,
  multi-field levels, non-canonical spans, width/depth overflow) is
  ineligible; the verdict is cached on the Commit (``_dev_enc``).
* ``DeviceRebaser.fold`` packs the eligible window prefix into one host
  buffer (pinned when the rebaser's device is the card), so a fold costs one
  host-to-device copy, one launch and one device-to-host copy; it decodes
  the surviving prefix back to pooled Commits (identity steps reuse the
  original objects outright; changed steps reattach object payloads through
  the source handles), and finishes the suffix on the pooled fold — the
  reference's own semantics for ineligible and invalidated steps, counted
  in ``fallback_steps``, never silent.

``fold`` is safe for concurrent callers: it holds the rebaser's lock from
the pack to the end of the pooled suffix.  The lock must cover the
read-back, because the ``non_blocking`` copy reads the reused pinned
buffer until the step rows come back; and it must cover the decode and
the suffix, because both seal spans into the shared ``MarkPool``, whose
allocator is not thread-safe.

Object payloads (insert content, nested Modify changesets, detached Remove
subtrees) never ride the device, so decoded commits serialize byte-
identically to the pooled fold's outputs.  A fold's three phases are
flight-recorder spans, as in the reference: ``rebase_kernel_encode``,
``rebase_kernel_dispatch`` (the round trip: copy up, launch, step rows
back) and ``rebase_kernel_decode``.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from ...device import DEFAULT_DEVICE, resolve_device
from ...observability.flight_recorder import span
from ...ops import rebase_kernel as rk
from ...ops.tree_kernel import REBASE_MAX_DEPTH, REBASE_MAX_MARKS
from ...protocol.mark_schema import (
    DEVICE_CODE_OFFSET,
    F_CANONICAL,
    F_INSERT,
    F_MODIFY,
    F_MOVE,
    F_REMOVE,
    K_INSERT,
    K_MODIFY,
    K_REMOVE,
    K_SKIP,
)
from .changeset import Commit, NodeChange
from .mark_pool import PooledMarks, rebase_pair

_PD = REBASE_MAX_DEPTH
_M = REBASE_MAX_MARKS
_ZEROS = np.zeros((_M,), np.int32)
_PAD = rk.pad_row()
_ENC = rk.ENC_WORDS

# Sentinel distinguishing "never encoded" from "encoded: ineligible".
_INELIGIBLE = False


class CommitEncoding:
    """Device columns for one eligible Commit (and their packed kernel row)
    plus the host-side keys (field names, value tuples, nested
    NodeChanges, the leaf span) the decode needs to rebuild byte-identical
    pooled commits."""

    __slots__ = (
        "dep", "fld", "pos", "val", "kind", "cnt", "det", "n",
        "names", "vals", "nodes", "leaf", "row",
    )

    def __init__(self, dep, fld, pos, val, kind, cnt, det, n,
                 names, vals, nodes, leaf) -> None:
        self.dep = dep
        self.fld = fld
        self.pos = pos
        self.val = val
        self.kind = kind
        self.cnt = cnt
        self.det = det
        self.n = n
        self.names = names
        self.vals = vals
        self.nodes = nodes
        self.leaf = leaf
        self.row = np.empty((_ENC,), np.int32)
        rk.pack_fields(self.row, dep, fld, pos, val, kind, cnt, det, n)


class DeviceRebaser:
    """Window dispatcher shared by a fleet's EditManagers (one instance
    keeps the field-interning table and the health counters fleet-wide,
    mirroring the engines' shared MarkPool).  ``device`` is where K9 runs:
    the card by default, ``"cpu"`` for its plain form.  One fold runs at a
    time (``_lock``; see the module note)."""

    def __init__(self, pool, device=DEFAULT_DEVICE) -> None:
        self.pool = pool
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        self._fields: dict[str, int] = {}
        self._host: dict[int, torch.Tensor] = {}  # window cap -> input buffer
        self.device_steps = 0     # window steps resolved on device
        self.fallback_steps = 0   # window steps finished by the pooled fold
        self.windows = 0          # folds that dispatched at least one step
        self.encode_rejects = 0   # commits that failed the eligibility walk

    # ------------------------------------------------------------- interning
    def _field_id(self, key: str) -> int:
        return self._fields.setdefault(key, len(self._fields))

    # -------------------------------------------------------------- encoding
    def encode_commit(self, commit):
        """CommitEncoding for an eligible pooled Commit, else None.
        The verdict (either way) is cached on the commit — pooled
        commits are immutable, so the cache can never go stale."""
        enc = getattr(commit, "_dev_enc", None)
        if enc is not None:
            return None if enc is _INELIGIBLE else enc
        enc = self._encode(commit)
        commit._dev_enc = _INELIGIBLE if enc is None else enc
        if enc is None:
            self.encode_rejects += 1
        return enc

    def _encode(self, commit):
        if len(commit) != 1 or commit.constraints or commit.violated:
            return None
        nc = commit[0]
        fld = np.full((_PD + 1,), -1, np.int32)
        pos = np.zeros((_PD,), np.int32)
        val = np.zeros((_PD + 1,), np.int32)
        names: list = []
        vals: list = []
        nodes: list = []
        level = 0
        while True:
            nodes.append(nc)
            vals.append(nc.value)
            if nc.value is not None:
                val[level] = 1
            fields = nc.fields
            if not fields:
                # value-only (or empty) leaf: fld stays -1
                names.append(None)
                return CommitEncoding(
                    np.int32(level), fld, pos, val,
                    _ZEROS, _ZEROS, _ZEROS, np.int32(0),
                    names, vals, nodes, None,
                )
            if len(fields) != 1:
                return None
            (key, fc), = fields.items()
            if type(fc) is not PooledMarks:
                return None
            if level < _PD:
                # interior test: exactly [Skip(p), Modify] (the nested
                # wire norm) keeps walking the spine
                ks, as_, _bs, _cs, objs, s = fc.columns()
                nested = None
                if fc.n == 2 and ks[s] == K_SKIP and ks[s + 1] == K_MODIFY:
                    nested = objs[s + 1]
                    p = as_[s]
                elif fc.n == 1 and ks[s] == K_MODIFY:
                    nested = objs[s]
                    p = 0
                if type(nested) is NodeChange:
                    fld[level] = self._field_id(key)
                    pos[level] = p
                    names.append(key)
                    nc = nested
                    level += 1
                    continue
            flags = fc.flags
            if flags & F_MOVE or not flags & F_CANONICAL or fc.n > _M:
                return None
            kind, cnt, det = fc.columns_padded(_M)
            fld[level] = self._field_id(key)
            names.append(key)
            return CommitEncoding(
                np.int32(level), fld, pos, val, kind, cnt, det,
                np.int32(fc.n), names, vals, nodes, fc,
            )

    # -------------------------------------------------------------- decoding
    def _seal_interior(self, p: int, nested) -> PooledMarks:
        """[Skip(p), Modify(nested)] (or bare [Modify]) as a fresh span."""
        if p > 0:
            return self.pool.seal(
                [K_SKIP, K_MODIFY], [p, 1], [0, 0], [0, 0],
                [None, nested], F_MODIFY | F_CANONICAL,
            )
        return self.pool.seal(
            [K_MODIFY], [1], [0], [0], [nested], F_MODIFY | F_CANONICAL,
        )

    def _seal_leaf(self, enc: CommitEncoding, kindv, cntv, slov, shiv,
                   nlive: int) -> PooledMarks:
        """Device leaf columns -> pooled span, object payloads reattached
        through the source-index handles into the ORIGINAL leaf span.
        Raw rows + seal (no Mark objects): the kernel's coalescing
        emission mirrors the host builder, so the columns are already
        canonical."""
        ks: list[int] = []
        as_: list[int] = []
        zs: list[int] = []
        objs: list = []
        flags = F_CANONICAL
        if enc.leaf is not None:
            sk, _sa, _sb, _sc, sobjs, ss = enc.leaf.columns()
        else:
            sk = sobjs = ()
            ss = 0
        for i in range(nlive):
            k = int(kindv[i]) - DEVICE_CODE_OFFSET
            a = int(cntv[i])
            obj = None
            if k == K_INSERT:
                flags |= F_INSERT
                lo = int(slov[i])
                hi = int(shiv[i])
                if lo == hi:
                    obj = sobjs[ss + lo]  # shared, like the host emit
                else:
                    # merged insert group: concatenate the original
                    # K_INSERT payloads in source order
                    obj = []
                    for j in range(lo, hi + 1):
                        if sk[ss + j] == K_INSERT:
                            obj = obj + sobjs[ss + j]
            elif k == K_REMOVE:
                # detached payloads only survive identity steps (which
                # never decode) — the kernel's det gate guarantees it
                flags |= F_REMOVE
            elif k == K_MODIFY:
                flags |= F_MODIFY
                obj = sobjs[ss + int(slov[i])]
            ks.append(k)
            as_.append(a)
            zs.append(0)
            objs.append(obj)
        return self.pool.seal(ks, as_, zs, list(zs), objs, flags)

    def _decode_side(self, enc: CommitEncoding, out, i: int, drops=None):
        """Rebuild one side's pooled Commit (+ fresh encoding stamp) from
        step ``i`` of the window outputs (``out``: a ``RebaseEnc`` of numpy
        views over the step rows)."""
        dep = int(out.dep[i])
        posv = out.pos[i]
        kindv = out.kind[i]
        cntv = out.cnt[i]
        nlive = int(out.n[i])
        slov = out.slo[i]
        shiv = out.shi[i]
        names = enc.names
        vals = list(enc.vals[: dep + 1])
        if drops is not None:
            for lvl in range(dep + 1):
                if drops[lvl]:
                    vals[lvl] = None
        # leaf level
        leaf_span = None
        if names[dep] is None:
            fields: dict = {}
        else:
            leaf_span = self._seal_leaf(enc, kindv, cntv, slov, shiv, nlive)
            fields = {names[dep]: leaf_span}
        nc = NodeChange(value=vals[dep], fields=fields)
        nodes = [nc]
        for lvl in range(dep - 1, -1, -1):
            nc = NodeChange(value=vals[lvl], fields={
                names[lvl]: self._seal_interior(int(posv[lvl]), nc),
            })
            nodes.append(nc)
        nodes.reverse()
        out_commit = Commit([nc])
        out_commit._pooled = True
        new_enc = CommitEncoding(
            np.int32(dep), enc.fld, posv.astype(np.int32),
            np.asarray([1 if v is not None else 0
                        for v in vals] + [0] * (_PD - dep), np.int32),
            kindv.astype(np.int32), cntv.astype(np.int32), _ZEROS,
            np.int32(nlive), names[: dep + 1], vals, nodes, leaf_span,
        )
        out_commit._dev_enc = new_enc
        return out_commit

    # ------------------------------------------------------------ dispatch
    def _host_buffer(self, cap: int) -> torch.Tensor:
        """The reused input buffer of a ``cap``-step window: c's row, cap
        entry rows, then cap eligibility bytes (pinned for the card)."""
        buf = self._host.get(cap)
        if buf is None:
            words = (1 + cap) * _ENC + -(-cap // 4)
            buf = torch.empty((words,), dtype=torch.int32,
                              pin_memory=self.device.type == "cuda")
            self._host[cap] = buf
        return buf

    def _dispatch(self, enc_c: CommitEncoding, encs: list, cap: int) -> np.ndarray:
        """One K9 window: the packed rows up in one copy, one launch, the
        step rows [cap, 160] back in one copy."""
        p = len(encs)
        buf = self._host_buffer(cap)
        host = buf.numpy()
        rows = host[: (1 + cap) * _ENC].reshape(1 + cap, _ENC)
        rows[0] = enc_c.row
        for i, e in enumerate(encs):
            rows[1 + i] = e.row
        rows[1 + p:] = _PAD
        elig = host[(1 + cap) * _ENC:].view(np.uint8)
        elig[:p] = 1
        elig[p:] = 0
        if self.device.type == "cuda":
            dev = buf.to(self.device, non_blocking=True)
        else:
            dev = buf
        c = dev[:_ENC].view(1, _ENC)
        xs = dev[_ENC: (1 + cap) * _ENC].view(1, cap, _ENC)
        el = dev[(1 + cap) * _ENC:].view(torch.uint8)[:cap].view(1, cap)
        _final, steps = rk.rebase_window(c, xs, el)
        return steps[0].cpu().numpy()

    def fold(self, c: Commit, xs: list):
        """One EditManager window fold: returns (final c, new xs values,
        stage values), device prefix + pooled-fold suffix.  ``xs`` is the
        list of window commits (tseq bookkeeping stays with the caller);
        the three return lists line up with it.  Serialized on ``_lock``."""
        with self._lock:
            return self._fold(c, xs)

    def _fold(self, c: Commit, xs: list):
        n = len(xs)
        with span("rebase_kernel_encode", window=n):
            enc_c = self.encode_commit(c)
            encs: list = []
            if enc_c is not None:
                for x in xs:
                    e = self.encode_commit(x)
                    if e is None:
                        break
                    encs.append(e)
        p = len(encs)
        k = 0
        new_xs: list = []
        stages: list = []
        if p:
            self.windows += 1
            cap = 1 << (p - 1).bit_length()
            with span("rebase_kernel_dispatch", window=n, steps=p, cap=cap):
                steps = self._dispatch(enc_c, encs, cap)
            with span("rebase_kernel_decode", window=n, steps=p):
                outs = rk.unpack_steps(steps)
                valid = outs.valid
                while k < p and valid[k]:
                    k += 1
                for i in range(k):
                    if outs.id_x[i]:
                        new_xs.append(xs[i])
                    else:
                        new_xs.append(self._decode_side(
                            encs[i], outs.x, i, drops=outs.x_drop[i]))
                    if not outs.id_c[i]:
                        # stage source handles compose into the ORIGINAL c
                        # across the window's steps — decode against enc_c
                        c = self._decode_side(enc_c, outs.stage, i)
                    stages.append(c)
        # pooled-fold suffix: ineligible entries, invalidated steps, and
        # everything behind them (prefix-validity contract)
        for i in range(k, n):
            c, xw = rebase_pair(c, xs[i])
            new_xs.append(xw)
            stages.append(c)
        self.device_steps += k
        self.fallback_steps += n - k
        return c, new_xs, stages

    # --------------------------------------------------------------- gauges
    def stats(self) -> dict:
        total = self.device_steps + self.fallback_steps
        return {
            "device_rebase_steps": self.device_steps,
            "rebase_fallbacks": self.fallback_steps,
            "rebase_windows": self.windows,
            "rebase_encode_rejects": self.encode_rejects,
            "device_rebase_fraction": (
                round(self.device_steps / total, 4) if total else 0.0
            ),
        }
