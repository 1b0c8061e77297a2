"""Columnar SharedMap kernel in PyTorch: batched last-writer-wins application.

Counterpart of ``fluidframework_tpu/ops/map_kernel.py``, held byte for byte
against it (every state column and the summary JSON).  The sequenced state
of a map is every set/delete/clear applied in sequence order (LWW by total
order), so a whole [B]-op batch collapses into one resolution: for each key
slot the winning op is the last set/delete after the last clear, and keys
untouched since the last clear are wiped.

What changes from the reference is the idiom: ``apply_batch_fleet`` takes a
state with a leading map axis in place of ``vmap`` (``apply_batch`` is its
one-map form), and each key's winning position is a ``scatter_reduce``
(amax) of the op positions over the [D, B] batch in place of the [K, B]
membership table (the same winner; positions of ops whose key is outside
[0, K) add nothing).  ``apply_batch_fleet.launches`` counts the programs
run on a CUDA device, one per call of either entry point.

Keys and values are host-interned to int32 ids (the channel adapter owns
the intern tables and reverse maps).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, count_launch, resolve_device

I32 = torch.int32


class MapOpKind:
    NOOP = 0
    SET = 1
    DELETE = 2
    CLEAR = 3


class MapState(NamedTuple):
    """Per-map sequenced state over K interned key slots ([D, K] and [D]
    for a fleet)."""

    values: torch.Tensor   # int32[K] interned value ids
    present: torch.Tensor  # int32[K] 0/1
    val_seq: torch.Tensor  # int32[K] seq of the winning write (attribution)
    error: torch.Tensor    # int32 scalar


def init_state(max_keys: int = 256, device=DEFAULT_DEVICE) -> MapState:
    """One empty map on ``device``."""
    dev = resolve_device(device)
    z = torch.zeros((max_keys,), dtype=I32, device=dev)
    return MapState(values=z, present=z.clone(), val_seq=z.clone(),
                    error=torch.zeros((), dtype=I32, device=dev))


def batch_state(state: MapState, n_maps: int) -> MapState:
    """A fleet of ``n_maps`` copies of one map (leading map axis)."""
    return MapState(*(x.unsqueeze(0).repeat((n_maps,) + (1,) * x.dim()) for x in state))


def map_state_from_numpy(state, device=DEFAULT_DEVICE) -> MapState:
    """A state from numpy-readable fields in ``MapState`` order (a reference
    state read with ``np.asarray``), as int32 tensors."""
    dev = resolve_device(device)
    return MapState(*(torch.as_tensor(np.array(x, np.int32)).to(dev) for x in state))


def _as_tensor(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=I32)
    return torch.as_tensor(np.asarray(x, np.int32), device=device)


def _apply(s: MapState, kinds, key_ids, values, seqs) -> MapState:
    D, K = s.values.shape
    B = kinds.shape[-1]
    bpos = torch.arange(1, B + 1, dtype=I32, device=kinds.device).expand(D, B)
    # Last clear position in the batch (0 = none).
    last_clear = torch.where(kinds == MapOpKind.CLEAR, bpos, 0).amax(-1, keepdim=True)
    # Per key: position of the last set/delete at/after the last clear.
    is_write = (kinds == MapOpKind.SET) | (kinds == MapOpKind.DELETE)
    in_range = (key_ids >= 0) & (key_ids < K)
    cand = torch.where(is_write & (bpos > last_clear) & in_range, bpos, 0)
    win = torch.zeros((D, K), dtype=I32, device=kinds.device).scatter_reduce_(
        1, key_ids.clamp(0, K - 1).long(), cand, "amax")
    wb = (win - 1).clamp(min=0).long()
    win_kind = kinds.gather(1, wb)
    win_val = values.gather(1, wb)
    win_seq = seqs.gather(1, wb)
    has_win = win > 0
    cleared = (last_clear > 0) & ~has_win
    is_set = has_win & (win_kind == MapOpKind.SET)
    return s._replace(
        values=torch.where(is_set, win_val, s.values),
        present=torch.where(has_win, is_set.to(I32), torch.where(cleared, 0, s.present)),
        val_seq=torch.where(has_win, win_seq, torch.where(cleared, 0, s.val_seq)),
    )


def apply_batch_fleet(s: MapState, kinds, key_ids, values, seqs) -> MapState:
    """Apply a [D, B] batch of sequenced ops (each map's already in sequence
    order) to a [D, K] fleet in one shot; key_ids are -1 for clear/noop."""
    count_launch(s.values, apply_batch_fleet)
    dev = s.values.device
    return _apply(s, *(_as_tensor(x, dev) for x in (kinds, key_ids, values, seqs)))


apply_batch_fleet.launches = 0


def apply_batch(s: MapState, kinds, key_ids, values, seqs) -> MapState:
    """Apply B sequenced ops to one map (the fleet program at D=1)."""
    count_launch(s.values, apply_batch_fleet)
    dev = s.values.device
    one = MapState(*(x[None] for x in s))
    out = _apply(one, *(_as_tensor(x, dev)[None] for x in (kinds, key_ids, values, seqs)))
    return MapState(*(x[0] for x in out))


def host_items(s: MapState) -> dict[int, int]:
    """{key_id: value_id} of one map's present entries (host view)."""
    present = s.present.cpu().numpy().astype(bool)
    values = s.values.cpu().numpy()
    return {int(k): int(values[k]) for k in np.nonzero(present)[0]}


# ----------------------------------------------------------------------------
# Summary-record codecs (byte-identical JSON to the reference's)
# ----------------------------------------------------------------------------

def state_to_summary(s: MapState) -> dict:
    """One map -> summary JSON: the sparse live slot set (slot, value, seq,
    present), exact — ``summary_to_state`` reproduces the columns."""
    values = s.values.cpu().numpy()
    present = s.present.cpu().numpy()
    val_seq = s.val_seq.cpu().numpy()
    live = np.nonzero((present != 0) | (val_seq != 0) | (values != 0))[0]
    return {
        "max_keys": int(values.shape[0]),
        "slots": [
            [int(k), int(values[k]), int(val_seq[k]), int(present[k])]
            for k in live
        ],
    }


def summary_to_state(summary: dict, max_keys: int | None = None,
                     device=DEFAULT_DEVICE) -> MapState:
    """Summary JSON -> a MapState identical to the one summarized.  Raises
    ValueError when a recorded slot does not fit ``max_keys``."""
    K = int(max_keys if max_keys is not None else summary["max_keys"])
    values = np.zeros((K,), np.int32)
    present = np.zeros((K,), np.int32)
    val_seq = np.zeros((K,), np.int32)
    for k, v, seq, pres in summary["slots"]:
        if not 0 <= k < K:
            raise ValueError(f"summary slot {k} outside max_keys {K}")
        values[k], val_seq[k], present[k] = v, seq, pres
    return map_state_from_numpy((values, present, val_seq, np.zeros((), np.int32)), device)
