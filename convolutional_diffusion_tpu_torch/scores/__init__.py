"""Analytic score machines — the paper's closed-form denoisers.

Ported so far: the ELS and bbELS modules, the LS module (bbELS's fallback
for k >= image size), the IS module (the exact score the CLI's `ideal/`
outputs come from) and the scheduled machine that drives them."""

from .bbels import LocalEquivBordersScoreModule
from .common import SoftmaxState, init_state, merge_states, update_state
from .els import LocalEquivScoreModule
from .ideal import IdealScoreModule
from .local import LocalScoreModule
from .machine import ScheduledScoreMachine

__all__ = [
    "IdealScoreModule",
    "LocalEquivBordersScoreModule",
    "LocalEquivScoreModule",
    "LocalScoreModule",
    "ScheduledScoreMachine",
    "SoftmaxState",
    "init_state",
    "update_state",
    "merge_states",
]
