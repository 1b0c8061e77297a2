"""The port's own copy of ``fluidframework_tpu/framework/synthesize.py`` (no JAX in it).

Dependency synthesizer: typed provider registry with scope chaining.

Reference parity: packages/framework/synthesize — ``DependencyContainer``
(dependencyContainer.ts): register providers under keys, synthesize an
object exposing OPTIONAL dependencies (None when absent) and REQUIRED ones
(resolution fails when absent), with parent-container fallback. Providers
may be plain values, factories (called once, memoized — the reference's
async provider resolution collapsed to lazy call), or instances.
"""

from __future__ import annotations

from typing import Any, Callable


class DependencyContainer:
    def __init__(self, parent: "DependencyContainer | None" = None) -> None:
        self._providers: dict[str, Any] = {}
        self._resolved: dict[str, Any] = {}
        self.parent = parent

    # ------------------------------------------------------------- registry
    def register(self, key: str, provider: Any) -> None:
        if key in self._providers:
            raise ValueError(f"provider already registered for {key!r}")
        self._providers[key] = provider

    def unregister(self, key: str) -> None:
        self._providers.pop(key, None)
        self._resolved.pop(key, None)

    def has(self, key: str, exclude_parents: bool = False) -> bool:
        if key in self._providers:
            return True
        if exclude_parents or self.parent is None:
            return False
        return self.parent.has(key)

    @property
    def registered_types(self) -> list[str]:
        return sorted(self._providers)

    # ----------------------------------------------------------- resolution
    def resolve(self, key: str) -> Any:
        if key in self._resolved:
            return self._resolved[key]
        if key in self._providers:
            provider = self._providers[key]
            value = provider() if callable(provider) else provider
            self._resolved[key] = value
            return value
        if self.parent is not None:
            return self.parent.resolve(key)
        raise KeyError(f"no provider for {key!r}")

    def synthesize(
        self,
        optional: list[str] | None = None,
        required: list[str] | None = None,
    ) -> "SynthesizedObject":
        """An object with one attribute per requested key: required keys
        must resolve (raise otherwise), optional keys default to None."""
        values: dict[str, Any] = {}
        for key in required or []:
            values[key] = self.resolve(key)  # raises when absent
        for key in optional or []:
            try:
                values[key] = self.resolve(key)
            except KeyError:
                values[key] = None
        return SynthesizedObject(values)


class SynthesizedObject:
    def __init__(self, values: dict[str, Any]) -> None:
        self._values = dict(values)

    def __getattr__(self, key: str) -> Any:
        try:
            return self._values[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __getitem__(self, key: str) -> Any:
        return self._values[key]

    def keys(self) -> list[str]:
        return sorted(self._values)
