"""The one error the port raises for what it has not ported yet."""

# ROADMAP.md items that hold what is still to port
ROADMAP_ITEMS = {
    "parallel": ("Queue A item 8b, the model axis: tensor parallelism (SpatialVLAPolicy.shard, "
                 "the mesh-sharded serving engines, --mesh_model)"),
}


def not_ported(what: str, item: str = "parallel") -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to spatialvla_tpu_torch yet "
        f"(see ROADMAP.md, {ROADMAP_ITEMS[item]})"
    )
