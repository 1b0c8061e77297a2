"""Feature-gate / config provider with typed cached reads.

A copy of ``fluidframework_tpu/utils/config.py`` (the reference module
imports no JAX; the port keeps its own copy).  Reference parity:
``IConfigProviderBase.getRawConfig(name)`` (packages/common/
core-interfaces/src/config.ts) consumed through ``CachedConfigProvider`` with
typed parsing (telemetry-utils/src/config.ts:193,240) and surfaced together
with a logger as ``MonitoringContext`` (config.ts:276). Feature gates are
dotted string keys, e.g. ``"FluidTpu.Runtime.CompressionEnabled"``, checked at
use sites; unset keys fall through to the caller's default.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping, Union

from .telemetry import Logger

ConfigTypes = Union[str, int, float, bool, list, None]


class CachedConfigProvider:
    """Layered typed config reads with per-key caching.

    ``providers`` are consulted in order; the first non-None raw value wins
    (ref CachedConfigProvider wraps an ordered provider chain). Raw values may
    be strings (parsed) or already-typed.
    """

    def __init__(
        self, *providers: Callable[[str], ConfigTypes] | Mapping[str, ConfigTypes]
    ) -> None:
        self._providers = [
            p if callable(p) else (lambda key, _m=p: _m.get(key)) for p in providers
        ]
        self._cache: dict[str, ConfigTypes] = {}

    def _raw(self, key: str) -> ConfigTypes:
        if key in self._cache:
            return self._cache[key]
        value: ConfigTypes = None
        for provider in self._providers:
            value = provider(key)
            if value is not None:
                break
        self._cache[key] = value
        return value

    def get_bool(self, key: str, default: bool | None = None) -> bool | None:
        v = self._raw(key)
        if v is None:
            return default
        if isinstance(v, bool):
            return v
        if isinstance(v, str):
            if v.lower() in ("true", "1"):
                return True
            if v.lower() in ("false", "0"):
                return False
        return default

    def get_number(self, key: str, default: float | None = None) -> float | None:
        v = self._raw(key)
        if v is None:
            return default
        if isinstance(v, bool):
            return default
        if isinstance(v, (int, float)):
            return v
        if isinstance(v, str):
            try:
                return float(v)
            except ValueError:
                return default
        return default

    def get_string(self, key: str, default: str | None = None) -> str | None:
        v = self._raw(key)
        return v if isinstance(v, str) else default


class MonitoringContext:
    """Logger + config pair threaded through subsystems (ref config.ts:276)."""

    def __init__(
        self, logger: Logger | None = None, config: CachedConfigProvider | None = None
    ) -> None:
        self.logger = logger if logger is not None else Logger()
        self.config = config if config is not None else CachedConfigProvider()

    def child(self, namespace: str, **properties: Any) -> "MonitoringContext":
        from .telemetry import create_child_logger

        return MonitoringContext(
            create_child_logger(self.logger, namespace, properties), self.config
        )
