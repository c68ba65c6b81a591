"""Analytic score machines — the paper's closed-form denoisers.

Ported so far: the ELS module and the scheduled machine that drives it."""

from .common import SoftmaxState, init_state, merge_states, update_state
from .els import LocalEquivScoreModule
from .machine import ScheduledScoreMachine

__all__ = [
    "LocalEquivScoreModule",
    "ScheduledScoreMachine",
    "SoftmaxState",
    "init_state",
    "update_state",
    "merge_states",
]
