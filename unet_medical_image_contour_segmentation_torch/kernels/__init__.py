"""Hand-written Hopper kernels: Python wrappers, plain versions and the nvcc build."""
