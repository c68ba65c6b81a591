"""Analysis of score fields and datasets: the exterior derivative (curl) of a
score field along a reverse trajectory (`exterior_derivative`), and
patch-distance statistics of image sets (`patch_statistics`). Counterpart of
`convolutional_diffusion_tpu/analysis/`."""
