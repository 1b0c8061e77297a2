"""The port's own copy of ``fluidframework_tpu/runtime/datastore.py`` (no JAX in it).

DataStoreRuntime: hosts channels, routes envelopes, owns the registry.

Reference parity: datastore/src/dataStoreRuntime.ts — ``FluidDataStoreRuntime``
(:258), ``ISharedObjectRegistry`` (:156, type string -> IChannelFactory),
``createChannel`` (:699), envelope routing via ChannelDeltaConnection.

Envelope nesting (ref channelCollection.ts:290): a datastore-level op is
``{"address": <channel id>, "contents": <dds op>}``; the container adds one
more ``{"address": <datastore id>, "contents": ...}`` wrapper.
"""

from __future__ import annotations

from typing import Any, Callable

from ..protocol.channel import (
    Channel,
    ChannelDeltaConnection,
    ChannelFactory,
    ChannelMessage,
    MessageCollection,
    MessageEnvelope,
    bunch_contiguous,
)


class DataStoreRuntime:
    """One data store: a registry-driven collection of channels."""

    def __init__(
        self,
        ds_id: str,
        registry: dict[str, ChannelFactory],
        submit_fn: Callable[[dict, Any], None],
        quorum_fn: Callable[[str], int],
        client_id_fn: Callable[[], str],
        members_fn: Callable[[], list[str]] | None = None,
        ref_seq_fn: Callable[[], int] | None = None,
        root: bool = True,
    ) -> None:
        self.id = ds_id
        # GC roots are always reachable; non-root (dynamically created)
        # stores survive only while a handle to them exists (ref aliased/
        # root datastores vs handle-reachable ones, container-runtime gc).
        self.is_root = root
        self._registry = registry
        self._submit = submit_fn
        self._quorum = quorum_fn
        self._client_id = client_id_fn
        self._members = members_fn
        self._ref_seq = ref_seq_fn
        self._channels: dict[str, Channel] = {}
        # channel id -> seq of its last sequenced change (summary dirtiness;
        # ref SummarizerNode invalidate on op). Channels created while live
        # are marked dirty from creation so summaries never emit handles
        # into snapshots that predate them (the attach op re-marks at its
        # own seq on every replica).
        self.changed_seqs: dict[str, int] = {}

    # ------------------------------------------------------------- channels
    def create_channel(self, channel_type: str, channel_id: str) -> Channel:
        ch = self._create_channel(channel_type, channel_id)
        # Dirty from creation: a summary handle may only reference channels
        # the previous snapshot already carries. (Detached creation marks 0,
        # which the initial snapshot covers; the attach op re-marks at its
        # own seq on every replica.)
        if self._ref_seq is not None:
            self.changed_seqs[channel_id] = max(
                self.changed_seqs.get(channel_id, 0), self._ref_seq()
            )
        return ch

    def _create_channel(self, channel_type: str, channel_id: str) -> Channel:
        if channel_id in self._channels:
            raise ValueError(f"channel {channel_id!r} already exists")
        factory = self._registry.get(channel_type)
        if factory is None:
            raise KeyError(
                f"no factory for channel type {channel_type!r} "
                f"(registered: {sorted(self._registry)})"
            )
        channel = factory.create(channel_id)
        self._bind(channel)
        return channel

    def _bind(self, channel: Channel) -> None:
        cid = channel.id

        def submit(contents: Any, local_metadata: Any, internal: bool = False) -> None:
            self._submit({"address": cid, "contents": contents}, local_metadata, internal)

        channel.connect(
            ChannelDeltaConnection(
                submit, self._quorum, self._client_id, self._members, self._ref_seq
            )
        )
        self._channels[cid] = channel

    def get_channel(self, channel_id: str) -> Channel:
        return self._channels[channel_id]

    @property
    def channels(self) -> dict[str, Channel]:
        return dict(self._channels)

    # --------------------------------------------------------------- inbound
    def process_messages(
        self, envelope: MessageEnvelope, messages: list[tuple[dict, bool, Any]]
    ) -> None:
        """Route a bunch of datastore-level messages to channels.

        ``messages`` items are (datastore-op, local, local_metadata); runs of
        contiguous same-channel messages become one MessageCollection (the
        bunching seam, containerRuntime.ts:3428).
        """
        def dispatch(addr: str, run: list[ChannelMessage]) -> None:
            if addr not in self._channels:
                raise KeyError(f"datastore {self.id!r}: unknown channel {addr!r}")
            self.changed_seqs[addr] = envelope.seq  # summary dirty tracking
            self._channels[addr].process_messages(
                MessageCollection(envelope=envelope, messages=run)
            )

        bunch_contiguous(
            (
                (
                    contents["address"],
                    ChannelMessage(
                        contents=contents["contents"],
                        local=local,
                        local_metadata=local_metadata,
                    ),
                )
                for contents, local, local_metadata in messages
            ),
            dispatch,
        )

    # ---------------------------------------------------- reconnect / stash
    def resubmit(self, contents: dict, local_metadata: Any, squash: bool = False) -> None:
        self._channels[contents["address"]].resubmit(
            contents["contents"], local_metadata, squash
        )

    def apply_stashed(self, contents: dict) -> Any:
        return self._channels[contents["address"]].apply_stashed(contents["contents"])

    def on_min_seq(self, min_seq: int) -> None:
        for ch in self._channels.values():
            ch.on_min_seq(min_seq)

    def on_client_leave(self, client_id: str, seq: int) -> None:
        for ch in self._channels.values():
            ch.on_client_leave(client_id, seq)

    def rollback(self, contents: dict, local_metadata: Any) -> None:
        self._channels[contents["address"]].rollback(contents["contents"], local_metadata)

    # ------------------------------------------------------------ checkpoint
    def summarize(self) -> dict[str, Any]:
        from .snapshot_formats import current_format

        return {
            "root": self.is_root,
            "channels": {
                cid: {
                    "type": ch.channel_type,
                    "fmt": current_format(ch.channel_type),
                    "summary": ch.summarize(),
                }
                for cid, ch in self._channels.items()
            }
        }

    def load(self, summary: dict[str, Any]) -> None:
        from .snapshot_formats import upgrade

        self.is_root = summary.get("root", True)
        for cid, entry in summary["channels"].items():
            if "meta" in entry:
                # Materialized incremental channel tree ({"meta", "forest"}):
                # the channel FACTORY reassembles the flat summary from the
                # per-chunk pieces (the load-side mirror of the generic
                # summary_tree emit hook — symmetric, no DDS import here).
                meta = entry["meta"]
                factory = self._registry.get(meta["type"])
                if factory is None or not hasattr(factory, "assemble_incremental"):
                    raise KeyError(
                        f"channel type {meta['type']!r} wrote an incremental "
                        "summary but its factory has no assemble_incremental"
                    )
                entry = {
                    "type": meta["type"],
                    "fmt": meta.get("fmt", 1),
                    "summary": factory.assemble_incremental(
                        meta["summary"],
                        [
                            entry["forest"][k]
                            for k in sorted(entry["forest"], key=int)
                        ],
                        meta.get("fmt", 1),
                    ),
                }
            # _create_channel: snapshot-loaded channels are covered by that
            # snapshot, not dirty.
            channel = self._create_channel(entry["type"], cid)
            # A None summary is structure-only (detached attach writes the
            # channel layout; content replays as trailing ops).
            if entry["summary"] is not None:
                channel.load(
                    upgrade(entry["type"], entry["summary"], entry.get("fmt", 1))
                )

    def summary_tree(self, covered_seq: int | None, prefix: str) -> dict[str, Any]:
        """Incremental summary subtree: a channel whose last sequenced
        change is at or below ``covered_seq`` (the last acked summary's
        refSeq) emits a handle to its previous summary content
        (ref SummarizerNode handle reuse)."""
        from .snapshot_formats import current_format
        from .summary import blob, handle, tree

        channels: dict[str, Any] = {}
        for cid, ch in self._channels.items():
            path = f"{prefix}/channels/{cid}"
            if covered_seq is not None and self.changed_seqs.get(cid, 0) <= covered_seq:
                channels[cid] = handle(path)
            elif hasattr(ch, "summary_tree"):
                # WITHIN-channel incrementality (SharedTree chunked forest,
                # ref incrementalSummarizationUtils): the channel emits its
                # own tree of blobs + handles.
                channels[cid] = ch.summary_tree(covered_seq, path)
            else:
                channels[cid] = blob(
                    {
                        "type": ch.channel_type,
                        "fmt": current_format(ch.channel_type),
                        "summary": ch.summarize(),
                    }
                )
        return tree({"channels": tree(channels)})

    def structure_summary(self) -> dict[str, Any]:
        """Layout-only summary: channel ids + types, no state."""
        return {
            "root": self.is_root,
            "channels": {
                cid: {"type": ch.channel_type, "summary": None}
                for cid, ch in self._channels.items()
            }
        }
