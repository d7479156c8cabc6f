"""Solvers: the exact iLQR loop, its options and the kernel engines."""
