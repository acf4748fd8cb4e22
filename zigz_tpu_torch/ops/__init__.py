"""Device operations of the port: BabyBear field ops, SHA3 (CUDA kernels K1
and K2 with their plain PyTorch versions), the device witness, MLE
evaluation, the Reed-Solomon row encode and the Ligero column sponges (CUDA
kernels K4 and K5).  Importing this package builds nothing and imports no
JAX."""
