"""The GPU wavefront engine and the tensor-twin contract."""
