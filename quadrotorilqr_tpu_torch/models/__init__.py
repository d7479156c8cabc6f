"""Dynamics models."""
