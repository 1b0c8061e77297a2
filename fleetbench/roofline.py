"""The bytes a fleet step has to move, from a configuration's shapes, and
the card's peaks.

A ``step()`` or ``compact()`` call that the harness makes covers every
doc of the fleet: it reads the fleet's state once and writes it once,
and a step also reads the staged op rows of the ops it applies.  The count follows the configuration, not
the program's launches: however many megasteps a step runs, it is the
same.  Every state column is int32.
"""

from __future__ import annotations

import json
from pathlib import Path

WORD = 4  # bytes of an int32

_PEAKS = Path(__file__).resolve().parent / "peaks.json"


def string_doc_words(g: dict) -> int:
    """One SharedString doc's state: the text pool, per segment its start,
    length, insert key and client, uid and obliterate stamp, a key and a
    client per remove slot, a key and a value per prop slot; per
    obliterate slot seven words; five scalars."""
    S, R, P = g["max_segments"], g["remove_slots"], g["prop_slots"]
    return g["text_capacity"] + (6 + 2 * R + 2 * P) * S + 7 * g["ob_slots"] + 5


def string_row_words(g: dict) -> int:
    """One staged string op: its eight fields and its payload."""
    return 8 + g["max_insert_len"]


def steps_bytes(g: dict, n_docs: int, steps: int, ops: int, compacts: int) -> int:
    """Bytes that ``steps`` fleet ``step()`` calls applying ``ops`` ops in
    all, and ``compacts`` fleet ``compact()`` calls, must move."""
    return WORD * (2 * n_docs * string_doc_words(g) * (steps + compacts)
                   + ops * string_row_words(g))


def peaks(device_name: str) -> dict | None:
    """The published peaks of a card by its name, None when not listed."""
    return json.loads(_PEAKS.read_text()).get(device_name)
