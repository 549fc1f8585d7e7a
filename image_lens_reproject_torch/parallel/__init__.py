"""Multi-device batching: the (batch, rows) mesh, the sharded remap step and
multi-process start-up, ported from the JAX package's ``parallel/``."""
