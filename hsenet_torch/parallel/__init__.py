"""Data and tensor parallelism over torch.distributed (the port of the JAX
package's parallel/mesh.py, sharding.py and zero.py)."""
