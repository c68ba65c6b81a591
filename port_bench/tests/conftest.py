"""Shared fixtures of the benchmark's CPU tests: a cell cut to a size the
CPU runs in seconds."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def tiny(cell):
    """The cell over 96 images of 12 x 12: the schedule's 20 steps with the
    kernel sizes capped at 9, so that its last steps are as sharp (t down
    to 0.05) as the cell's."""
    scales = [min(k, 9) for k in cell.config["scales"]]
    cfg = dict(cell.config, num_images=96, image_size=12, scales=scales,
               target_block=2048, scorebatchsize=16)
    return cell._replace(config=cfg)


@pytest.fixture
def tiny_cell():
    from port_bench import spec

    return lambda name: tiny(spec.load(name, ROOT))
