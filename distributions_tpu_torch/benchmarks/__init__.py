"""The port's measurement entry points, each runnable as
`python -m distributions_tpu_torch.benchmarks.<name>`: `roofline` (what
the card does per second: B2, B3, B4), `suite` (the sampler alone, B1,
and the hyper-grid and mixture rates), `kernel_phases` (K1 cut into
phases, B5), `bench` (the nich sweep loop) and `bench_runner`
(`run_gibbs`).  They run on the package's default device, the card, and
read their sizes from the environment so that a test can run them small on
the CPU."""
