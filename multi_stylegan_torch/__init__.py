"""PyTorch/CUDA port of Multi-StyleGAN (the JAX package multi_stylegan_tpu is its reference)."""
