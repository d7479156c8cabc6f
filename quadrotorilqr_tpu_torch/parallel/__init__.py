"""Batch helpers."""
