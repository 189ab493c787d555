"""Device memory budget shared by the memory-sized choices of the package."""

from __future__ import annotations

import jax

# stand-in where the backend reports no memory limit (the host CPU
# backend used by the tests)
HOST_MEMORY_BYTES = 16 << 30


def device_memory_bytes() -> int:
    """Bytes JAX may allocate on the first device (``bytes_limit`` of its
    ``memory_stats()``), or ``HOST_MEMORY_BYTES`` where none is reported."""
    stats = jax.devices()[0].memory_stats()
    if stats and stats.get("bytes_limit"):
        return int(stats["bytes_limit"])
    return HOST_MEMORY_BYTES
