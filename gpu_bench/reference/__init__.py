"""The plain reference that decides ``correct``: a frozen copy of the port's
model and training math (``multi_stylegan_torch``'s models, nn, ops/blur,
ops/modulated_conv and train modules, as they stood when the benchmark was
written, less what it never runs), on plain PyTorch ops only.

What differs from the port: the fused bias + leaky ReLU and upfirdn2d are
their plain versions (``ops.py``) differentiated by autograd, with no
kernel; one process, so every data-axis reduction is the plain expression
(``single.py``); the draws come from ``draws.py``, which the benchmark also
hands to the port.  Nothing here imports the port, ``jax`` or the JAX
package, and nothing takes a tensor the port made: the weights are made
again from the seed (``weights.py``).
"""
