"""The port's own copy of ``fluidframework_tpu/framework/tree_agent.py`` (no JAX in it).

tree-agent: LLM-driven editing of a SharedTree behind a typed guardrail.

Reference parity: packages/framework/tree-agent — the schema is rendered
into a prompt, the model returns edit commands, and the agent validates +
applies them through the typed view, feeding errors back for retry. The
LLM itself is a pluggable callable (``llm(prompt) -> str``); nothing here
performs network I/O, so tests drive it with deterministic fakes and hosts
plug in a real model client.

Command protocol (the JSON the model must emit — a list of):
  {"op": "setValue", "path": [[field, idx], ...], "value": ...}
  {"op": "setField", "path": [...], "field": str, "value": ...}
  {"op": "insert", "path": [...], "field": str, "index": int, "items": [...]}
  {"op": "remove", "path": [...], "field": str, "index": int, "count": int}
"""

from __future__ import annotations

import json
from typing import Any, Callable

from ..dds.tree.changeset import make_insert, make_remove, make_set_value
from ..dds.tree.schema import FieldKind, SchemaRegistry, leaf


def render_schema_prompt(registry: SchemaRegistry) -> str:
    """Schema -> textual system prompt (ref tree-agent schema prompting)."""
    lines = ["The document tree follows this schema:"]
    for name, node in registry.nodes.items():
        fields = ", ".join(
            f"{k}: {fs.kind.value}<{'|'.join(sorted(fs.allowed_types))}>"
            for k, fs in node.fields.items()
        )
        lines.append(f"- node {name} {{ {fields} }}")
    if registry.root is not None:
        lines.append(
            f"- root: {registry.root.kind.value}"
            f"<{'|'.join(sorted(registry.root.allowed_types))}>"
        )
    lines.append(
        "Respond ONLY with a JSON list of edit commands using ops "
        "setValue/setField/insert/remove as documented."
    )
    return "\n".join(lines)


class TreeAgentError(Exception):
    pass


class TreeAgent:
    """Drives edits on a SharedTreeChannel from natural-language asks."""

    def __init__(self, channel, llm: Callable[[str], str], max_attempts: int = 3) -> None:
        self._channel = channel
        self._llm = llm
        self._max_attempts = max_attempts

    # ------------------------------------------------------------- execution
    @staticmethod
    def _apply_commands(commands: list[dict], forest_like, submit) -> None:
        """Apply one command list against ``forest_like`` (its node_at for
        state-dependent commands) through ``submit(change)``."""
        for cmd in commands:
            op = cmd.get("op")
            path = [tuple(p) for p in cmd.get("path", [])]
            if op == "setValue":
                submit(make_set_value(path, cmd["value"]))
            elif op == "setField":
                node = forest_like.node_at(path)
                count = len(node.fields.get(cmd["field"], []))
                if count:
                    submit(make_remove(path, cmd["field"], 0, count))
                submit(make_insert(path, cmd["field"], 0, [leaf(cmd["value"])]))
            elif op == "insert":
                items = [leaf(v) for v in cmd["items"]]
                submit(make_insert(path, cmd["field"], cmd["index"], items))
            elif op == "remove":
                submit(make_remove(path, cmd["field"], cmd["index"], cmd["count"]))
            else:
                raise TreeAgentError(f"unknown command op {op!r}")

    def _validate_on_probe(self, commands: list[dict]) -> None:
        """Dry-run the WHOLE list on a throwaway forest clone (schema check
        included) so a mid-list failure never leaves partial edits behind."""
        from ..dds.tree.changeset import apply_node_change
        from ..dds.tree.forest import Forest

        probe = Forest()
        probe.load_json(self._channel.forest.to_json())
        self._apply_commands(
            commands, probe, lambda ch: apply_node_change(probe.root, ch)
        )
        errors = self._channel.schema.check_forest(probe)
        if errors:
            raise TreeAgentError(f"edits violate the schema: {errors}")

    def run(self, instruction: str) -> list[dict]:
        """Ask the model for edits and apply them; malformed output and
        schema violations feed back as retry context (ref tool-loop
        retries). Commands are validated atomically on a probe before
        touching the live tree, and every attempt sees the CURRENT state.
        Returns the applied command list."""
        feedback = ""
        for _ in range(self._max_attempts):
            prompt = (
                render_schema_prompt(self._channel.schema)
                + "\nCurrent tree (JSON): "
                + json.dumps(self._channel.forest.to_json())
                + "\nInstruction: "
                + instruction
                + feedback
            )
            raw = self._llm(prompt)
            try:
                commands = json.loads(raw)
                if not isinstance(commands, list):
                    raise ValueError("expected a JSON list of commands")
                self._validate_on_probe(commands)
            except Exception as e:  # noqa: BLE001 — feeds back to the model
                feedback = f"\nYour previous response failed: {e!r}. Try again."
                continue
            self._apply_commands(
                commands, self._channel.forest, self._channel.submit_change
            )
            return commands
        raise TreeAgentError(f"no valid edit after {self._max_attempts} attempts")
