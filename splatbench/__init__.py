"""The benchmark of the PyTorch and CUDA port (gaussiansplats3d_tpu_torch)."""
