"""Hand-written CUDA kernels for Hopper (csrc/) and their Python wrappers.

Importing this package builds nothing: `_build.load()` compiles the kernels
on the first launch.
"""
