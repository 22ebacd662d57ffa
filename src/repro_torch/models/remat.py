"""The ``"dots"`` policy of the layer stacks' rematerialization
(``models/zoo.py:_maybe_remat``, the counterpart of ``repro``'s
``jax.checkpoint(body, policy=jax.checkpoint_policies.
dots_with_no_batch_dims_saveable)``): the ``context_fn`` of a non-reentrant
``torch.utils.checkpoint`` that keeps the outputs of the products without
batch dimensions that the backward needs and computes everything else
again.

It decides a product's batch dimensions as JAX does, from the product
itself: an ``einsum`` has one where an index is in both operands and in the
output (``bsd,df->bsf`` none; ``xecd,edf->xecf`` and ``bshr,btr->bhst``
one), a ``matmul`` where both operands are batched (a 2-d right operand:
none).  The port computes every product by ``torch.einsum`` or ``@``, and at
the aten level both kinds are ``bmm`` (or ``mm``), so the name of the aten op
cannot tell them apart: a function mode (:class:`_MarkProducts`) reads the
call and a dispatch mode (:class:`_SaveProducts`) keeps the ``mm``/``bmm``
output of a marked call.  JAX keeps a saveable value only when the backward
needs it: the down projection whose output is only added into the block's
output is computed again, not kept.  torch's
``create_selective_checkpoint_contexts`` keeps every output its policy
names, needed or not (one more activation a block than JAX), so the port
follows the product's use instead: an output that reaches only additions
and views before the body returns is dropped when the forward ends, and the
recompute (:class:`_ReuseProducts`) computes a dropped product again and
returns a kept one.  Either way the values are the same bits: a kept output
is the forward's own, a recomputed one the same call on the same operands.
"""

from __future__ import annotations

import functools

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.weak import WeakIdKeyDictionary

_aten = torch.ops.aten
#: the aten ops a marked product reaches
_PRODUCTS = frozenset((_aten.mm.default, _aten.bmm.default))
#: ops whose backward reads no value of their input: a product's output
#: that reaches only these before the body returns is not needed again
_VALUE_FREE = frozenset((
    _aten.add.Tensor, _aten.sub.Tensor, _aten.view.default,
    _aten._unsafe_view.default, _aten.expand.default, _aten.permute.default,
    _aten.transpose.int, _aten.t.default, _aten.unsqueeze.default,
    _aten.squeeze.dim, _aten.squeeze.default, _aten.slice.Tensor,
    _aten.select.int, _aten.alias.default, _aten.clone.default,
    _aten.detach.default))


@functools.lru_cache(maxsize=None)
def einsum_has_batch_dims(eq: str) -> bool:
    """Whether a two-operand ``einsum`` has a batch dimension: an index in
    both operands and in the output (``dot_general``'s batch dims)."""
    ins, out = eq.replace(" ", "").split("->")
    ops = ins.split(",")
    return len(ops) == 2 and bool(set(ops[0]) & set(ops[1]) & set(out))


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _tensors(t)
    elif isinstance(tree, dict):
        for t in tree.values():
            yield from _tensors(t)


class _Store:
    """One checkpointed call's kept products, by their order in the body."""

    def __init__(self):
        self.marking = False       # inside a product without batch dims
        self.saved: list = []      # the forward's outputs (None: dropped)
        self.needed: set[int] = set()
        # tensor -> the products whose values reach it by value-free ops
        self.derived = WeakIdKeyDictionary()


class _MarkProducts(TorchFunctionMode):
    """Marks the products without batch dimensions while they run."""

    def __init__(self, store: _Store):
        super().__init__()
        self.store = store

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", "")
        mark = False
        if name == "einsum" and isinstance(args[0], str):
            mark = len(args) == 3 and not einsum_has_batch_dims(args[0])
        elif name in ("matmul", "__matmul__") and len(args) == 2:
            mark = args[1].dim() == 2 or args[0].dim() <= 2
        if not mark:
            return func(*args, **kwargs)
        self.store.marking = True
        try:
            return func(*args, **kwargs)
        finally:
            self.store.marking = False


class _SaveProducts(TorchDispatchMode):
    """The forward: keeps each marked product's output and follows where it
    goes; at the end drops the outputs no backward needs."""

    def __init__(self, store: _Store):
        super().__init__()
        self.store = store

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        st = self.store
        srcs = set()
        for t in _tensors(args):
            srcs |= st.derived.get(t, frozenset())
        if st.marking and func in _PRODUCTS:
            st.needed |= srcs      # a product's backward reads its operands
            st.derived[out] = {len(st.saved)}
            st.saved.append(out.detach())
        elif func in _VALUE_FREE:
            if srcs:
                for o in _tensors(out):
                    st.derived[o] = srcs
        else:
            st.needed |= srcs
        return out

    def __exit__(self, *exc):
        st = self.store
        st.saved = [t if i in st.needed else None
                    for i, t in enumerate(st.saved)]
        st.derived = WeakIdKeyDictionary()
        return super().__exit__(*exc)


class _ReuseProducts(TorchDispatchMode):
    """The recompute: a kept product returns the forward's output, a dropped
    one runs again."""

    def __init__(self, store: _Store):
        super().__init__()
        self.store = store
        self.i = 0

    def __enter__(self):
        self.i = 0
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        st = self.store
        if st.marking and func in _PRODUCTS:
            i, self.i = self.i, self.i + 1
            kept = st.saved[i]
            if kept is not None:
                return kept.detach()
        return func(*args, **(kwargs or {}))


class _Both:
    """Enters a function mode and a dispatch mode together."""

    def __init__(self, fmode, dmode):
        self.modes = (fmode, dmode)

    def __enter__(self):
        for m in self.modes:
            m.__enter__()
        return self

    def __exit__(self, *exc):
        for m in reversed(self.modes):
            m.__exit__(*exc)
        return False


def dots_contexts():
    """``context_fn`` of a ``"dots"`` checkpoint: (forward, recompute)."""
    st = _Store()
    return (_Both(_MarkProducts(st), _SaveProducts(st)),
            _Both(_MarkProducts(st), _ReuseProducts(st)))

