"""The port's own copy of ``fluidframework_tpu/runtime/blob_manager.py`` (no JAX in it).

BlobManager: attachment blobs with upload, dedup, and summary linkage.

Reference parity: container-runtime/src/blobManager/blobManager.ts:237 —
large binary payloads do NOT ride the op stream; they upload to storage
first, a sequenced BlobAttach op ties the storage id into the document, and
summaries carry the attached-blob table so loading clients can resolve
handles.  Content addressing gives upload dedup for free (identical
payloads share one storage id — ref blobManager dedup of pending uploads).

Handles are plain strings ``blob:<id>`` so they can be stored in any DDS
value; the GC reference scan (runtime/gc.py) recognizes them.
"""

from __future__ import annotations

from typing import Callable


BLOB_PREFIX = "blob:"


class BlobManager:
    def __init__(
        self,
        upload: Callable[[str], str],
        read: Callable[[str], str],
        submit_attach: Callable[[str], None],
    ) -> None:
        self._upload = upload
        self._read = read
        self._submit_attach = submit_attach
        # blob id -> attached (sequenced) flag; pending ids await their ack.
        self._attached: set[str] = set()
        self._pending: set[str] = set()

    # ------------------------------------------------------------------ write
    def create_blob(self, content: str) -> str:
        """Upload + stage the attach op; returns the handle immediately
        (optimistic, like any local op — usable before the ack)."""
        blob_id = self._upload(content)
        if blob_id in self._attached or blob_id in self._pending:
            return BLOB_PREFIX + blob_id  # dedup: already on its way
        self._pending.add(blob_id)
        self._submit_attach(blob_id)
        return BLOB_PREFIX + blob_id

    def on_attach(self, blob_id: str) -> None:
        """A sequenced BlobAttach (ours or a remote's)."""
        self._pending.discard(blob_id)
        self._attached.add(blob_id)

    def delete(self, blob_id: str) -> None:
        """GC sweep removes an unreferenced blob from the table."""
        self._attached.discard(blob_id)

    # ------------------------------------------------------------------- read
    def get_blob(self, handle: str) -> str:
        assert handle.startswith(BLOB_PREFIX), f"not a blob handle: {handle!r}"
        blob_id = handle[len(BLOB_PREFIX):]
        if blob_id not in self._attached and blob_id not in self._pending:
            raise KeyError(f"blob {blob_id!r} is not attached to this document")
        return self._read(blob_id)

    @property
    def attached_ids(self) -> list[str]:
        return sorted(self._attached)

    # ------------------------------------------------------------ checkpoint
    def summarize(self) -> dict:
        return {"attached": sorted(self._attached)}

    def load(self, data: dict) -> None:
        self._attached = set(data.get("attached", []))
