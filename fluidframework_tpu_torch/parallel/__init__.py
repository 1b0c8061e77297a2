"""Placement planes and the long-document query plane."""
