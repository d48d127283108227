# Hand-written Hopper kernels: their ctypes wrappers and plain PyTorch
# versions.  Sources live in ../../csrc/.
