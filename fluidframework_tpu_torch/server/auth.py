"""Tenant auth: token signing and validation (riddler analog).

A port of ``fluidframework_tpu/server/auth.py`` (no JAX in it).

Reference parity: routerlicious' riddler service + jwt token flow
(routerlicious-base/src/riddler): tenants hold signing keys; a client
presents a token scoped to (tenant, document, client); fronts validate
before admitting the connection. HMAC-SHA256 over the scope triple stands
in for JWT (no external deps)."""

from __future__ import annotations

import hashlib
import hmac
import secrets

from ..protocol.driver_contracts import AuthRejection


class AuthError(AuthRejection):
    """Token validation failure.  Subclasses the contracts-tier
    ``AuthRejection`` so drivers can map admission rejections to
    non-retryable errors without importing the service tier."""


def _scope_bytes(tenant_id: str, doc_id: str, client_id: str) -> bytes:
    """Unambiguous scope encoding: length-prefixed components.

    A raw f"{tenant}:{doc}:{client}" concatenation aliases scopes when ids
    contain ':' (doc='a:b', client='c' vs doc='a', client='b:c'); prefixing
    each UTF-8 component with its byte length removes the ambiguity."""
    out = bytearray()
    for part in (tenant_id, doc_id, client_id):
        raw = part.encode()
        out += len(raw).to_bytes(4, "big")
        out += raw
    return bytes(out)


class TokenManager:
    """Tenant registry + token mint/validate."""

    def __init__(self) -> None:
        self._tenants: dict[str, bytes] = {}

    def create_tenant(self, tenant_id: str, key: str | None = None) -> str:
        k = key if key is not None else secrets.token_hex(16)
        self._tenants[tenant_id] = k.encode()
        return k

    def sign(self, tenant_id: str, doc_id: str, client_id: str) -> str:
        key = self._tenants.get(tenant_id)
        if key is None:
            raise AuthError(f"unknown tenant {tenant_id!r}")
        scope = _scope_bytes(tenant_id, doc_id, client_id)
        mac = hmac.new(key, scope, hashlib.sha256).hexdigest()
        return f"{tenant_id}:{mac}"

    def validate(self, token: str | None, doc_id: str, client_id: str) -> str:
        """Returns the tenant id or raises AuthError."""
        if not token or ":" not in token:
            raise AuthError("missing or malformed token")
        tenant_id, mac = token.rsplit(":", 1)
        key = self._tenants.get(tenant_id)
        if key is None:
            raise AuthError(f"unknown tenant {tenant_id!r}")
        scope = _scope_bytes(tenant_id, doc_id, client_id)
        want = hmac.new(key, scope, hashlib.sha256).hexdigest()
        if not hmac.compare_digest(mac, want):
            raise AuthError("invalid token signature")
        return tenant_id
