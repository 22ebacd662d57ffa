"""Hand-written CUDA kernels for Hopper, one package each:

  arena  -- the four arena slice ops of the executor (csrc/arena.cu)

Each package keeps beside its kernels a plain PyTorch version of the same
function (used for CPU tensors and as the reference the kernels are held
against) and a launch count per kernel.
"""
