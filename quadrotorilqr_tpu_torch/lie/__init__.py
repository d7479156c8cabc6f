"""SO(3) and SE(3) Lie groups (manif conventions), PyTorch."""

from . import se3, so3  # noqa: F401
