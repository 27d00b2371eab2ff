"""Device-side code of the port: the quorum predicate and its CUDA
kernel, the Merkle lane hash, and the fused engine step."""
