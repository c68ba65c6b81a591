"""convolutional_diffusion_tpu_torch — the PyTorch/CUDA port of
`convolutional_diffusion_tpu`, for NVIDIA Hopper (H100).

The JAX package stays the reference; this package keeps its module layout,
class names and public conventions (NHWC at the API, the score — not epsilon
— returned by score modules, `__call__(t, x, label=None, k=None, order=None)`)
so one numpy array feeds both. It imports `torch`, numpy and the standard
library only, never `jax` and never the JAX package.

Ported so far: the analytic score machines (`scores`: ELS, bbELS, LS and
IS modules at every precision tier, driven by `ScheduledScoreMachine`),
`data`, `pipeline` and `cli.els`; and the neural serving half: the
backbones (`models`), reference pickles and JAX params carried across
(`convert`), the DDIM/DDPM samplers (`sampling`, `cli.sample`) and scale
calibration against the CNN (`calibration`, `cli.calibrate`); and training
(`training`, resumable checkpoints in `utils.checkpoint`, `cli.train`,
`cli.train_64x64`); and `parallel` over `torch.distributed` (dataset-sharded
score modules, data-parallel training, seed-sharded sampling, one process
per device). `analysis/` is not ported yet. Entry points run on `cuda`
unless the caller passes `device="cpu"`; without a card they raise. On a CUDA tensor the flash-score sweep launches the hand-written
Hopper kernels in `ops/csrc/`; on a CPU tensor it runs their plain PyTorch
versions. The backbones and their training run cuDNN, cuBLAS and PyTorch's
fused AdamW (the JAX models and trainer have no Pallas kernel).

Submodules are imported explicitly (`from convolutional_diffusion_tpu_torch
import scores`); importing the package itself loads nothing else.
"""

__version__ = "0.1.0"
