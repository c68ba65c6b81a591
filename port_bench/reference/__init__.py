"""The benchmark's plain reference of the analytic score machines: plain
PyTorch, no kernel, nothing of the program and nothing of JAX. `machine.
sample` runs one seed through the reverse diffusion; `els` and `bbels` give
the scores; `common` holds the schedule, the products at each precision and
the weights."""
