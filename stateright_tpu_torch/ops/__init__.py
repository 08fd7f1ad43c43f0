"""Device ops: fingerprints, the bucketized visited set, and their CUDA kernels."""
