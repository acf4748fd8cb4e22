"""Device operations of the port: BabyBear field ops, SHA3 (CUDA kernels K1
and K2 with their plain PyTorch versions), the device witness and MLE
evaluation.  Importing this package builds nothing and imports no JAX."""
