"""The multi-rank layer of the port: torch.distributed process groups in
place of the JAX package's jax.sharding.Mesh (subgnn_tpu/parallel/)."""
