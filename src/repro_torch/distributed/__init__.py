from repro_torch.distributed.sharding import (  # noqa: F401
    LOGICAL_RULES,
    Mesh,
    current_mesh,
    device_mesh,
    logical_to_spec,
    set_mesh,
    shard,
    sharding_for,
    spec_tree_to_shardings,
    use_mesh,
)
