"""PyTorch/CUDA port of jegal_tpu."""
