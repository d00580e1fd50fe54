"""The one error the port raises for what it has not ported yet."""

# ROADMAP.md items that hold what is still to port
ROADMAP_ITEMS = {
    "model_sp_pipe": ("Queue A item 8d, the model axis with sp or pipe: --mesh_model with "
                      "--mesh_sp / --mesh_pp, or with the ring and pipeline backends"),
}


def not_ported(what: str, item: str = "model_sp_pipe") -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to spatialvla_tpu_torch yet "
        f"(see ROADMAP.md, {ROADMAP_ITEMS[item]})"
    )
