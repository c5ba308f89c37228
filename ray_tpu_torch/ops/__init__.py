"""Device-side primitives: RNG, math helpers, ray/triangle intersection and
traversal, and the build/launch plumbing of the CUDA kernels."""
