"""The GPU wavefront engines (single-device and sharded) and the
tensor-twin contract."""
