from .accum import (
    GenomeLayout,
    accumulate_depth,
    accumulate_depth_numpy,
    depth_dict_from_flat,
)


def resolve_auto_backend(platform: str | None = None) -> str:
    """The depth backend ``auto`` stands for: ``device`` on an accelerator
    backend, ``events`` (the host event-space path) on the CPU.
    ``platform`` defaults to jax's default backend; ``GCI_AUTO_BACKEND``
    overrides."""
    import os

    override = os.environ.get("GCI_AUTO_BACKEND")
    if override:
        valid = {"events", "device", "streamed", "sharded", "numpy"}
        if override not in valid:
            raise ValueError(
                f"GCI_AUTO_BACKEND={override!r} is not a known depth backend"
                f" (expected one of {sorted(valid)})"
            )
        return override
    if platform is None:
        import jax

        platform = jax.default_backend()
    return "events" if platform == "cpu" else "device"


__all__ = [
    "GenomeLayout",
    "accumulate_depth",
    "accumulate_depth_numpy",
    "depth_dict_from_flat",
    "resolve_auto_backend",
]
