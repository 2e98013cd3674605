"""Point and attention ops: kernels A-D on CUDA, plain PyTorch on the CPU."""
