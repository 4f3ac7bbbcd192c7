"""Linear algebra, column coloring and the CUDA kernels K1 and K2."""
