"""Solver options: the three frozen dataclasses of
`quadrotorilqr_tpu/solver/options.py`, copied verbatim.

`populate_debug` records the per-iteration debug record (`IterDebug` from
the batch loops, `CostHistory` from the whole-solve kernel; see api.py).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class LineSearchParams:
    step_update: float = 0.5
    desired_reduction_frac: float = 0.5
    max_iters: int = 100


@dataclass(frozen=True)
class ConvergenceCriteria:
    rtol: float = 1e-12
    atol: float = 1e-12
    max_iters: int = 100


@dataclass(frozen=True)
class ILQROptions:
    line_search_params: LineSearchParams = LineSearchParams()
    convergence_criteria: ConvergenceCriteria = ConvergenceCriteria()
    populate_debug: bool = False
    # Levenberg-style Quu regularization: Quu + quu_reg * I before the gain
    # solve. 0.0 is the unregularized reference behaviour.
    quu_reg: float = 0.0
