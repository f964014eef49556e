"""Device memory budget for the size-gated caches and chunking
(ops/socp.py curvature cache, models/lasso.py sample chunks)."""

from __future__ import annotations

import jax

# A backend that reports no memory limit (the CPU backend) is budgeted
# this many bytes.
HOST_BYTES_LIMIT = 8 * 2**30


def device_bytes_limit(device=None) -> int:
    """Bytes the allocator may hand out on ``device`` (default: the first
    local device): ``memory_stats()["bytes_limit"]``, or
    ``HOST_BYTES_LIMIT`` when the backend reports none."""
    device = jax.local_devices()[0] if device is None else device
    stats = device.memory_stats() or {}
    return int(stats.get("bytes_limit", HOST_BYTES_LIMIT))
