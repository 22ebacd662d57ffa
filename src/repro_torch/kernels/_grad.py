"""Autograd guards of the kernel wrappers.

The CUDA kernels are ctypes launches, which autograd does not see: an
output a kernel computed carries no ``grad_fn``, and a loss built on it
would back-propagate through everything but the kernel without an error.
So on the card a wrapper whose inputs need a gradient either runs a
``torch.autograd.Function`` with a backward kernel (the flash attention's
``FlashAttentionFn``, the RG-LRU's ``RGLRUFn``, WKV-6's ``WKV6Fn``) or
raises :func:`no_backward`'s error (the arena ops, attention outside the
backward's forms); it never returns a detached output.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _local


def on_card(t) -> bool:
    """Whether ``t`` lies on the card: the one test of the device by which
    the wrappers pick a kernel or its plain version.  A DTensor is judged
    by its local shard (its own ``is_cuda`` follows its mesh)."""
    return _local.local(t).is_cuda


def needs_grad(*tensors) -> bool:
    """Whether autograd is recording and one of ``tensors`` (None and
    non-tensors skipped) requires a gradient."""
    return torch.is_grad_enabled() and any(
        torch.is_tensor(t) and t.requires_grad for t in tensors)


class NoBackward(NotImplementedError):
    """A call on the card needs a gradient that no backward kernel takes:
    attention outside the flash backward's forms (``kernel.
    check_backward``: an offset or a cut ``kv_len``, a causal call with
    ``Sq != Skv``, a window on a non-causal call, causal head dims other
    than (64, 64), (128, 128), (192, 128) and (256, 256), non-causal ones
    other than (64, 64)), or an arena op.  No config the port trains makes
    such a call.  The dry-run writes a train cell that raises it as not
    applicable."""


def no_backward(op: str, kernel: str) -> NoBackward:
    """The error of a kernel wrapper called on the card under autograd
    when ``kernel``, its backward, is not ported yet."""
    return NoBackward(
        f"{op}: an input requires a gradient, and its backward kernel "
        f"({kernel}) is not ported yet (ROADMAP B); on the card run it "
        f"under torch.no_grad(), or train on the CPU")
