"""The one error the port raises for what it has not ported yet."""

# ROADMAP.md items that hold what is still to port
ROADMAP_ITEMS = {
    "parallel": ("Queue A item 8c, the model axis in training: --mesh_model in the pretrain and "
                 "fine-tune CLIs and make_mesh with model > 1"),
}


def not_ported(what: str, item: str = "parallel") -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to spatialvla_tpu_torch yet "
        f"(see ROADMAP.md, {ROADMAP_ITEMS[item]})"
    )
