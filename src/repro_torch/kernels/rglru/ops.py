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
never falls back.  The kernels have no backward yet (ROADMAP B): on the
card, under autograd with an input that requires a gradient, the call
raises ``NotImplementedError`` rather than return an output autograd
cannot see through.
"""

from __future__ import annotations

from repro_torch.kernels import _grad, _local
from repro_torch.kernels.rglru import kernel as _kernel
from repro_torch.kernels.rglru.ref import rglru_ref
from repro_torch.parallel.sharding import copy_into

IMPLS = ("auto", "cuda", "torch", "ref")



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
            raise _grad.no_backward("rglru", "the RG-LRU backward")
        return _kernel.rglru_cuda(log_a, gx, h0, state_out=state_out)
    return rglru_ref(log_a, gx, h0, state_out)
