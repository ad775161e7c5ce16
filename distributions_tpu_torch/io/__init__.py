"""Files: stream containers and mixture checkpoints
(distributions_tpu.io)."""
