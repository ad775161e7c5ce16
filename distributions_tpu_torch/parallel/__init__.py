"""Sharded collapsed-Gibbs sweeps (sharding) and process groups
(distributed): the port of distributions_tpu.parallel."""
