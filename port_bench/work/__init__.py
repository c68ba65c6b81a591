"""The work of one machine call, as least times of its sweeps
(`roofline.Sweep`): one module per reference score module, found by the
configuration's `reference`, each with `sweeps(config, labels, admitted,
seed_labels)`."""

from __future__ import annotations

import importlib


def sweeps_fn(name: str):
    return importlib.import_module(f"{__package__}.{name}").sweeps
