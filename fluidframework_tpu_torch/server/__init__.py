"""Serving tier: ordered log and checkpoint store, git summary store, scribe,
fleet consumer and its entry point, failover."""
