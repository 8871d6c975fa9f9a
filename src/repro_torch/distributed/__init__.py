"""The §8 mesh over ``torch.distributed`` (port of ``repro/distributed``):
``mesh`` (``MeshConfig``, placement, tensor parallelism, the rank
runner), ``sharding`` (the partition rules), ``shard_wrap`` (the kernels
on local shards) and ``comm`` (the collectives)."""
