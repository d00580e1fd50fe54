"""The one error the port raises for what it has not ported yet."""

# ROADMAP.md items that hold what is still to port
ROADMAP_ITEMS = {
    "serving": "Queue A item 3, the serving options still to port (shard)",
    "parallel": "Queue A item 8, parallelism",
}


def not_ported(what: str, item: str = "serving") -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to spatialvla_tpu_torch yet "
        f"(see ROADMAP.md, {ROADMAP_ITEMS[item]})"
    )
