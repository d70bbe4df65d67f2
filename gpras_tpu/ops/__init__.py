"""Device compute ops: kernel Gram builders, Cholesky/solves, k-means, splines."""
