"""The distributed layer: the (data, model) mesh over ``torch.distributed``,
batch and track sharding, replication, the tensor-parallel rules
(``mesh``), and the launcher of local ranks (``launch``)."""

from .mesh import (
    DATA, MODEL, ModelAxis, Sharding, cross_replica_mean, data_sharding, default_backend,
    host_local_put, init_distributed, make_mesh, mesh_device, replicate_params, replicated,
    shard_batch, shard_of, shard_params_tp, tensor_parallel_spec, tp_axis, track_sharding,
)
