"""Region math of the PyTorch port: host numpy, torch and CUDA kernels."""
