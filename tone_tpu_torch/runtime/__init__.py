"""runtime of the PyTorch/CUDA port."""
