"""Public WKV-6 op: impl dispatch.

``wkv6(r, k, v, w, u, *, initial_state, impl)``:

  * ``"auto"``          -- the CUDA kernel for tensors on the card,
                           ``"torch"`` for tensors on the CPU;
  * ``"cuda"``          -- the CUDA kernel (``csrc/wkv6.cu``); raises for
                           a tensor on the CPU;
  * ``"torch"``/``"ref"`` -- the exact sequential loop in plain PyTorch
                           (:func:`~repro_torch.kernels.rwkv6.ref.wkv6_ref`,
                           the plain version the kernel is held against;
                           the CPU path).

No environment variable changes the choice: a CUDA tensor under
``"auto"`` launches the kernel or raises; it never falls back.  Under
autograd on the card (grad enabled and an input that requires a gradient)
the call is :class:`WKV6Fn`: the forward kernel, and for the gradient the
backward kernel (``kernel.wkv6_backward_cuda``, ``csrc/wkv6_backward.cu``);
its plain version is ``ref.wkv6_backward_torch``.  An in-place
``state_out`` (serving's cache threading) is refused there with a
``ValueError``: training passes none.
``repro``'s chunked-linear-attention note applies here too: the exact
sequential update is the one that cannot overflow.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _grad, _local
from repro_torch.kernels.rwkv6 import kernel as _kernel
from repro_torch.kernels.rwkv6.ref import wkv6_ref
from repro_torch.parallel.sharding import copy_into

IMPLS = ("auto", "cuda", "torch", "ref")


class WKV6Fn(torch.autograd.Function):
    """WKV-6 on the card with a hand-written gradient: the forward is the
    forward kernel (``kernel.wkv6_cuda``) and the backward the backward
    kernel (``kernel.wkv6_backward_cuda``), which recomputes the f32
    states from the saved inputs (the outputs are not kept).  ``apply(r,
    k, v, w, u, s0)`` -> (out, sT); s0 may be None.  Autograd hands the
    backward a zero gradient for an output the loss does not use (sT, in
    training)."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0):
        r, k, v, w, u = (x.contiguous() for x in (r, k, v, w, u))
        s0 = None if s0 is None else s0.contiguous()
        out, sT = _kernel.wkv6_cuda(r, k, v, w, u, initial_state=s0,
                                     state_out=None)
        ctx.save_for_backward(r, k, v, w, u, s0)
        return out, sT

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout, dsT):
        r, k, v, w, u, s0 = ctx.saved_tensors
        return _kernel.wkv6_backward_cuda(
            r, k, v, w, u, s0, dout.contiguous(),
            None if dsT is None else dsT.contiguous())



def _pick_impl(impl: str, r) -> str:
    if impl == "auto":
        return "cuda" if _grad.on_card(r) else "torch"
    if impl not in IMPLS:
        raise ValueError(f"unknown wkv6 impl {impl!r}; expected one of "
                         f"{IMPLS}")
    return impl


def wkv6(r, k, v, w, u, *, initial_state=None, impl: str = "auto",
         state_out=None):
    """r,k,v,w: (B,T,H,N); u: (H,N).  Returns (out (B,T,H,N), state
    (B,H,N,N) f32).  ``state_out`` (f32, (B,H,N,N)) receives the final
    state and is returned; it may be ``initial_state`` itself, which then
    is updated in place.

    DTensor inputs run on their local shards (``kernels/_local.py``),
    batch and heads sharded where they divide; a DTensor ``state_out``
    receives its shard of the state."""
    if _local.has_dtensor(r, k, v, w, u, initial_state, state_out):
        x4 = {"batch": 0, "heads": 2}
        st = {"batch": 0, "heads": 1}

        def run(r, k, v, w, u, s0):
            return wkv6(r, k, v, w, u, initial_state=s0, impl=impl)

        out, state = _local.call_local(
            "wkv6", run, (r, k, v, w, u, initial_state),
            (x4, x4, x4, x4, {"heads": 0},
             st if initial_state is not None else None), (x4, st))
        if state_out is not None:
            copy_into(state_out, state)
            state = state_out
        return out, state
    impl = _pick_impl(impl, r)
    if impl == "cuda":
        if not _grad.on_card(r):
            raise ValueError("impl='cuda' needs CUDA tensors; got r on "
                             f"{r.device}")
        if _grad.needs_grad(r, k, v, w, u, initial_state):
            if state_out is not None:
                raise ValueError(
                    "wkv6 under autograd takes no state_out (an in-place "
                    "state has no gradient); training passes none")
            return WKV6Fn.apply(r, k, v, w, u, initial_state)
        return _kernel.wkv6_cuda(r, k, v, w, u, initial_state=initial_state,
                                 state_out=state_out)
    return wkv6_ref(r, k, v, w, u, initial_state, state_out)
