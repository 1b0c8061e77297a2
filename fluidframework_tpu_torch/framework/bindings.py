"""The port's own copy of ``fluidframework_tpu/framework/bindings.py`` (no JAX in it).

View bindings: reactive reads over channels (the react-hooks analog).

Reference parity: packages/framework/react (+ quill-react) binds UI
components to DDSes — a hook subscribes to a channel, exposes a snapshot,
and re-renders the component when relevant ops land.  A Python host plane
has no React, but the contract is the same three pieces, idiomatically:

- ``use_channel(runtime, ds, channel, selector)`` returns a ``Binding``
  whose ``value`` is the selector's latest result and which invokes
  registered callbacks ONLY when a processed batch touched that channel
  AND the selected value actually changed (the hooks' shallow-compare
  rerender gate);
- ``Binding.map`` derives further bindings;
- dispose() unhooks (the unmount path — repeated mount/unmount must not
  accumulate listeners, mirroring useEffect cleanup).

Local (optimistic) edits invalidate through the same feed once their ops
sequence; for immediate local echo, read ``value`` — selectors always
compute against the live channel.
"""

from __future__ import annotations

from typing import Any, Callable


class Binding:
    """One subscribed view over a channel (a mounted hook instance)."""

    def __init__(
        self,
        runtime,
        datastore_id: str,
        channel_id: str,
        selector: Callable[[Any], Any],
    ) -> None:
        self._runtime = runtime
        self._key = (datastore_id, channel_id)
        self._channel = runtime.datastore(datastore_id).get_channel(channel_id)
        self._selector = selector
        self._listeners: list[Callable[[Any], None]] = []
        self._last = self._compute()
        self._disposed = False
        runtime.op_processed_listeners.append(self._on_batch)

    def _compute(self) -> Any:
        return self._selector(self._channel)

    # ----------------------------------------------------------------- reads
    @property
    def value(self) -> Any:
        """The selector over the LIVE channel (includes local optimistic
        state, like a hook reading during render)."""
        return self._compute()

    # ---------------------------------------------------------------- events
    def on_change(self, fn: Callable[[Any], None]) -> Callable[[], None]:
        """fn(new_value) when a sequenced batch changed the selected value;
        returns the unsubscribe handle."""
        self._listeners.append(fn)

        def off() -> None:
            if fn in self._listeners:
                self._listeners.remove(fn)

        return off

    def _on_batch(self, touched: set) -> None:
        if self._key not in touched:
            return
        new = self._compute()
        if new == self._last:
            return  # the rerender gate: irrelevant ops don't notify
        self._last = new
        for fn in list(self._listeners):
            fn(new)

    # ------------------------------------------------------------ derivation
    def map(self, fn: Callable[[Any], Any]) -> "Binding":
        """A derived binding selecting ``fn(selector(channel))``."""
        return Binding(
            self._runtime, self._key[0], self._key[1],
            lambda ch, s=self._selector: fn(s(ch)),
        )

    # ------------------------------------------------------------- lifecycle
    def dispose(self) -> None:
        if not self._disposed:
            self._disposed = True
            if self._on_batch in self._runtime.op_processed_listeners:
                self._runtime.op_processed_listeners.remove(self._on_batch)
            self._listeners.clear()


def use_channel(runtime, datastore_id: str, channel_id: str,
                selector: Callable[[Any], Any]) -> Binding:
    """The generic hook (ref react useSharedObject)."""
    return Binding(runtime, datastore_id, channel_id, selector)


def use_shared_map(runtime, datastore_id: str, channel_id: str) -> Binding:
    """Snapshot of a SharedMap as a plain dict (ref useSharedMap)."""
    return use_channel(
        runtime, datastore_id, channel_id,
        lambda ch: {k: ch.get(k) for k in sorted(ch.keys())},
    )


def use_shared_string(runtime, datastore_id: str, channel_id: str) -> Binding:
    """The live text (ref quill-react's text binding)."""
    return use_channel(runtime, datastore_id, channel_id, lambda ch: ch.text)


def use_tree(runtime, datastore_id: str, channel_id: str,
             selector: Callable[[Any], Any] | None = None) -> Binding:
    """SharedTree binding: selector over the channel (e.g. a typed-view
    read); defaults to the root-field JSON (ref useTree)."""
    return use_channel(
        runtime, datastore_id, channel_id,
        selector or (lambda ch: [n.to_json() for n in ch.forest.root_field]),
    )
