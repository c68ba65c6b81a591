"""Command-line entry points of the port (`python -m
convolutional_diffusion_tpu_torch.cli.<name>`). Ported so far: `els`."""
