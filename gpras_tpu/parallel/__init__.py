"""Multi-device distribution over a device mesh: sharded Gram, distributed Cholesky,
sharded PCA. The reference has no distributed runtime (SURVEY.md section 2.2);
these are greenfield components built on jax.sharding + shard_map
collectives (psum / all_gather / ppermute; XLA hands them to NCCL on GPUs),
not a port of any MPI layer.
"""

from gpras_tpu.parallel.mesh import make_mesh  # noqa: F401
