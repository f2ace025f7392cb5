from repro_torch.sharding.specs import (  # noqa: F401
    PartitionSpec,
    batch_specs,
    cache_specs,
    engine_state_sharding,
    leaf_spec,
    param_specs,
    plane_sharding,
    shard_engine_state,
    tree_specs,
    unshard_engine_state,
)
