"""Hand-written CUDA kernels for Hopper, one package each:

  arena            -- the four arena slice ops of the executor
                      (csrc/arena.cu)
  flash_attention  -- GQA forward attention with an online softmax: the
                      split-K decode (csrc/flash_decode.cu), the wgmma
                      prefill (csrc/flash_prefill_sm90.cu) and the simple
                      kernel (csrc/flash_attention.cu), by a fixed route;
                      and the training form's gradient, by a fixed route
                      too (csrc/flash_backward_sm90.cu on the tensor
                      cores for bf16, csrc/flash_backward.cu for f32)
  rwkv6            -- the RWKV-6 WKV recurrence (csrc/wkv6.cu)
  rglru            -- Griffin's RG-LRU recurrence (csrc/rglru.cu)
  optim            -- the train step's global-norm clip and AdamW update,
                      two multi-tensor kernels over every leaf
                      (csrc/adamw.cu)

``_build`` compiles each ``csrc/*.cu`` with nvcc into its own library;
``_grad`` keeps every wrapper from returning, under autograd on the card,
an output that autograd cannot see through.

Each package keeps beside its kernels a plain PyTorch version of the same
function (used for CPU tensors and as the reference the kernels are held
against) and a launch count per kernel.
"""
