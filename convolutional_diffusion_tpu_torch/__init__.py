"""convolutional_diffusion_tpu_torch — the PyTorch/CUDA port of
`convolutional_diffusion_tpu`, for NVIDIA Hopper (H100).

The JAX package stays the reference; this package keeps its module layout,
class names and public conventions (NHWC at the API, the score — not epsilon
— returned by score modules, `__call__(t, x, label=None, k=None, order=None)`)
so one numpy array feeds both. It imports `torch`, numpy and the standard
library only, never `jax` and never the JAX package.

Ported so far: the fp32 ELS score machine (`scores.ScheduledScoreMachine`
driving `scores.LocalEquivScoreModule`) and what it stands on. Entry points
run on `cuda` unless the caller passes `device="cpu"`; without a card they
raise. On a CUDA tensor the flash-score sweep launches the hand-written
Hopper kernel in `ops/csrc/flash_score.cu`; on a CPU tensor it runs the
kernel's plain PyTorch version.

Submodules are imported explicitly (`from convolutional_diffusion_tpu_torch
import scores`); importing the package itself loads nothing else.
"""

__version__ = "0.1.0"
