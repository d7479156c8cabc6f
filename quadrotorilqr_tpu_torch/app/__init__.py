"""Workloads."""
