"""Data, tensor, pipeline and sequence parallelism over torch.distributed
(the port of the JAX package's parallel/mesh.py, sharding.py, zero.py,
pipeline.py and sp.py)."""
