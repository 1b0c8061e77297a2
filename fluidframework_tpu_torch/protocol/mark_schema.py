"""The shared mark-schema plane: pool codes, span flags, device codes.

The port's own copy of ``fluidframework_tpu/protocol/mark_schema.py``
(unchanged): the port imports nothing of the JAX package, so it keeps the
host algebra here.

Sequence-field marks exist in three storages that must agree on numbering:
the object marks (dds/tree/changeset.py dataclasses), the pooled int32
columns (dds/tree/mark_pool.py), and the device tensors
(ops/tree_kernel.py).  The kind codes and per-span structural flags are a
CONTRACT shared by all three — a pooled span streams straight into a
kernel encoding, and a kernel output decodes straight back into pool
columns, so any renumbering must hit every side at once.  The schema
therefore lives here in ``protocol`` (base layer) where dds, models and
ops all import it downward; the device codes used to live in
ops/tree_kernel.py, which made the kernel's host-list encoder an upward
importer of the changeset classes (fftpu-check rule
``layer-upward-import``, marker_plane idiom).

Two numbering planes, one offset:

- POOL codes (``K_*``): dense 0-based kinds for the columnar mark store.
  Every mark row is (kind, a, b, c, obj); 0 = Skip is a real mark.
- DEVICE codes (``TreeMarkKind``): the same kinds shifted by +1 so that
  0 = NOOP can pad fixed-width [M] kernel lanes.  ``DEV = POOL + 1``
  (``DEVICE_CODE_OFFSET``) — a pooled kind column uploads with one add.
"""

# --- pool codes (columnar store; 0 = Skip is a real mark) -----------------
K_SKIP, K_INSERT, K_REMOVE, K_MODIFY, K_MOVEOUT, K_MOVEIN = 0, 1, 2, 3, 4, 5

# --- per-span structural flags (computed at seal, read on every rebase) ---
F_INSERT, F_REMOVE, F_MOVE, F_MODIFY, F_CANONICAL = 1, 2, 4, 8, 16
F_STRUCTURAL = F_INSERT | F_REMOVE | F_MOVE

# --- sentinels -------------------------------------------------------------
NONE_OFF = -1  # MoveIn "whole register" offset (real offsets are >= 0)

# --- device codes (0 pads fixed-width kernel lanes) ------------------------
DEVICE_CODE_OFFSET = 1  # TreeMarkKind.<X> == K_<X> + 1


class TreeMarkKind:
    NOOP = 0  # padding
    SKIP = K_SKIP + DEVICE_CODE_OFFSET
    INSERT = K_INSERT + DEVICE_CODE_OFFSET
    REMOVE = K_REMOVE + DEVICE_CODE_OFFSET
    MODIFY = K_MODIFY + DEVICE_CODE_OFFSET
    MOVEOUT = K_MOVEOUT + DEVICE_CODE_OFFSET
    MOVEIN = K_MOVEIN + DEVICE_CODE_OFFSET
