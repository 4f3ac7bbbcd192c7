"""Canonical problems."""
