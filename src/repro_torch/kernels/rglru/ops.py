"""Public RG-LRU op: impl dispatch.

``rglru(log_a, gx, h0, *, impl)``:

  * ``"auto"``          -- the CUDA kernels for tensors on the card,
                           ``"torch"`` for tensors on the CPU;
  * ``"cuda"``          -- the CUDA kernels (``csrc/rglru.cu``: the step
                           kernel for T <= ``kernel.STEP_MAX_T``, the
                           staged kernel beyond, by ``kernel.pick_route``);
                           raises for a tensor on the CPU;
  * ``"torch"``/``"ref"`` -- the sequential recurrence in plain PyTorch
                           (:func:`~repro_torch.kernels.rglru.ref.rglru_ref`,
                           the plain version the kernel is held against;
                           the CPU path).

``repro``'s ``"xla"`` associative scan has no counterpart: the tests hold
the plain version against it.  No environment variable changes the
choice: a CUDA tensor under ``"auto"`` launches the kernel or raises; it
never falls back.  Under autograd on the card (grad enabled and an input
that requires a gradient) the call is :class:`RGLRUFn`: the routed
forward kernel, and for the gradient the backward kernel
(``kernel.rglru_backward_cuda``); its plain version is
``ref.rglru_backward_torch``.  An in-place ``state_out`` (serving's cache
threading) is refused there with a ``ValueError``: training passes none.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _grad, _local
from repro_torch.kernels.rglru import kernel as _kernel
from repro_torch.kernels.rglru.ref import rglru_ref
from repro_torch.parallel.sharding import copy_into

IMPLS = ("auto", "cuda", "torch", "ref")


class RGLRUFn(torch.autograd.Function):
    """The RG-LRU on the card with a hand-written gradient: the forward is
    the routed forward kernel (``kernel.rglru_cuda``) and the backward the
    backward kernel (``kernel.rglru_backward_cuda``), which recomputes the
    f32 carries from the saved inputs.  ``apply(log_a, gx, h0)`` -> (h,
    hT); h0 may be None.  Autograd hands the backward a zero gradient
    for an output the loss does not use (hT, in training)."""

    @staticmethod
    def forward(ctx, log_a, gx, h0):
        log_a, gx = log_a.contiguous(), gx.contiguous()
        h0 = None if h0 is None else h0.contiguous()
        h, hT = _kernel.rglru_cuda(log_a, gx, h0)
        ctx.save_for_backward(log_a, gx, h0)
        return h, hT

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dh, dhT):
        log_a, gx, h0 = ctx.saved_tensors
        dla, dgx, dh0 = _kernel.rglru_backward_cuda(
            log_a, gx, h0, dh.contiguous(), dhT.contiguous())
        return dla, dgx, dh0


def _pick_impl(impl: str, gx) -> str:
    if impl == "auto":
        return "cuda" if _grad.on_card(gx) else "torch"
    if impl not in IMPLS:
        raise ValueError(f"unknown rglru impl {impl!r}; expected one of "
                         f"{IMPLS}")
    return impl


def rglru(log_a, gx, h0=None, *, impl: str = "auto", state_out=None):
    """log_a, gx: (B,T,D).  Returns (h (B,T,D) in gx's dtype, h_T (B,D)
    f32).  ``state_out`` (f32, (B,D)) receives h_T and is returned; it may
    be ``h0`` itself, which then is updated in place.

    DTensor inputs run on their local shards (``kernels/_local.py``),
    batch and channels sharded where they divide (each channel is its own
    recurrence); a DTensor ``state_out`` receives its shard of h_T."""
    if _local.has_dtensor(log_a, gx, h0, state_out):
        x3 = {"batch": 0, "heads": 2}
        st = {"batch": 0, "heads": 1}

        def run(log_a, gx, h0):
            return rglru(log_a, gx, h0, impl=impl)

        h, hT = _local.call_local(
            "rglru", run, (log_a, gx, h0),
            (x3, x3, st if h0 is not None else None), (x3, st))
        if state_out is not None:
            copy_into(state_out, hT)
            hT = state_out
        return h, hT
    impl = _pick_impl(impl, gx)
    if impl == "cuda":
        if not _grad.on_card(gx):
            raise ValueError("impl='cuda' needs CUDA tensors; got gx on "
                             f"{gx.device}")
        if _grad.needs_grad(log_a, gx, h0):
            if state_out is not None:
                raise ValueError(
                    "rglru under autograd takes no state_out (an in-place "
                    "hT has no gradient); training passes none")
            return RGLRUFn.apply(log_a, gx, h0)
        return _kernel.rglru_cuda(log_a, gx, h0, state_out=state_out)
    return rglru_ref(log_a, gx, h0, state_out)
