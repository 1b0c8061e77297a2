"""The SharedString fleet: ``DocBatchEngine`` fed wire lines through
``ingest_lines``, stepped with ``step()`` and ``compact()``; its view of a
doc is ``text(d)``, held against the plain merge-tree replica."""

from __future__ import annotations

from ..reference import merge_tree


class Family:
    def __init__(self, config: dict, device: str):
        self.config = config
        self.engine_args = dict(config["engine"])
        self.n_docs = self.engine_args.pop("n_docs")
        self.geometry = config["engine"]
        self.device = device

    def new_engine(self):
        from fluidframework_tpu_torch.models.doc_batch_engine import DocBatchEngine

        return DocBatchEngine(self.n_docs, device=self.device, **self.engine_args)

    def boot(self, blobs: list[bytes], spans, sync):
        """A fleet engine of the cell's shapes, its programs warmed, every
        doc's boot lines (joins and prefix history) ingested and applied."""
        with spans("boot"):
            eng = self.new_engine()
            eng.warmup()
            for d, blob in enumerate(blobs):
                eng.ingest_lines(d, blob)
            self.step(eng, True)
            sync()
        return eng

    @staticmethod
    def ingest(eng, doc: int, blob: bytes) -> None:
        eng.ingest_lines(doc, blob)

    @staticmethod
    def step(eng, compact: bool) -> None:
        eng.step()
        if compact:
            eng.compact()

    @staticmethod
    def off_path(eng) -> int:
        """Docs served off the fleet batch: grown into an overflow lane,
        quarantined, or on a host oracle."""
        return len(eng.overflow) + len(eng.quarantine) + len(eng.oracles)

    @staticmethod
    def view(eng, doc: int) -> str:
        return eng.text(doc)

    @staticmethod
    def reference_view(data: bytes) -> str:
        return merge_tree.replay(data)
