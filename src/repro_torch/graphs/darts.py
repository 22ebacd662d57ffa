"""DARTS learned normal cell (Liu et al., ICLR 2019) as a SERENITY graph.

Published DARTS_V2 genotype, normal cell:

    normal = [(sep_conv_3x3, 0), (sep_conv_3x3, 1),
              (sep_conv_3x3, 0), (sep_conv_3x3, 1),
              (sep_conv_3x3, 1), (skip_connect, 0),
              (skip_connect, 0), (dil_conv_3x3, 2)]
    concat = [2, 3, 4, 5]

Each intermediate node sums two operand branches; a sep_conv is the standard
ReLU-Conv(dw)-Conv(1x1)-BN stack applied twice; dil_conv applies it once.  The
paper evaluates the *first* normal cell of the ImageNet network (highest
footprint): feature maps 28x28, C=48 channels after the stem, float32.

``darts_normal_cell`` — the single-cell benchmark above.
``darts_network``     — the deployed form: one discovered cell repeated
``n_cells`` times.  ``double_skip=False`` (default) wires each cell off its
predecessor's output only, the hourglass chain the hierarchical scheduler
decomposes exactly; ``double_skip=True`` adds the genotype's ``c_{k-2}``
skip, which keeps *two* tensors live across every cell boundary — no
single-node separator exists and the search has to rely on pruning alone
(the stress case for branch and bound).
"""

from __future__ import annotations

from repro_torch.core.graph import Graph

# (op, input_index) pairs per intermediate node; indices 0,1 are the two cell
# inputs, 2.. are previous intermediate nodes.
DARTS_V2_NORMAL = [
    [("sep_conv_3x3", 0), ("sep_conv_3x3", 1)],   # node 2
    [("sep_conv_3x3", 0), ("sep_conv_3x3", 1)],   # node 3
    [("sep_conv_3x3", 1), ("skip_connect", 0)],   # node 4
    [("skip_connect", 0), ("dil_conv_3x3", 2)],   # node 5
]
CONCAT = [2, 3, 4, 5]


def _add_cell(
    specs: list[dict],
    in0: int,
    in1: int,
    *,
    fmap: int,
    sep_w: int,
    tag: str = "",
) -> int:
    """Append one DARTS_V2 normal cell reading (in0, in1); returns the
    concat node id (the cell output before the transition conv)."""

    def add(name, op, size, preds=(), weight=0):
        specs.append(
            dict(name=name, op=op, size_bytes=size, preds=list(preds),
                 weight_bytes=weight)
        )
        return len(specs) - 1

    def sep_conv(tag_: str, src: int) -> int:
        # ReLU -> dwconv -> pwconv -> BN, twice (DARTS SepConv definition).
        x = src
        for rep in range(2):
            r = add(f"{tag_}.relu{rep}", "relu", fmap, [x])
            d = add(f"{tag_}.dw{rep}", "depthconv", fmap, [r],
                    weight=sep_w // 2)
            p = add(f"{tag_}.pw{rep}", "conv", fmap, [d], weight=sep_w // 2)
            x = add(f"{tag_}.bn{rep}", "bn", fmap, [p])
        return x

    def dil_conv(tag_: str, src: int) -> int:
        r = add(f"{tag_}.relu", "relu", fmap, [src])
        d = add(f"{tag_}.dw", "depthconv", fmap, [r], weight=sep_w // 2)
        p = add(f"{tag_}.pw", "conv", fmap, [d], weight=sep_w // 2)
        return add(f"{tag_}.bn", "bn", fmap, [p])

    node_out = {0: in0, 1: in1}
    for i, edges in enumerate(DARTS_V2_NORMAL):
        node_id = i + 2
        branch_outs = []
        for j, (op, src_idx) in enumerate(edges):
            src = node_out[src_idx]
            btag = f"{tag}n{node_id}.e{j}.{op}"
            if op == "sep_conv_3x3":
                branch_outs.append(sep_conv(btag, src))
            elif op == "dil_conv_3x3":
                branch_outs.append(dil_conv(btag, src))
            elif op == "skip_connect":
                branch_outs.append(src)
            else:
                raise ValueError(op)
        node_out[node_id] = add(f"{tag}n{node_id}.add", "add", fmap,
                                branch_outs)

    concat_in = [node_out[i] for i in CONCAT]
    return add(f"{tag}cell.concat", "concat", fmap * len(CONCAT), concat_in)


def darts_normal_cell(
    hw: int = 28, channels: int = 48, dtype_bytes: int = 4
) -> Graph:
    fmap = hw * hw * channels * dtype_bytes          # one C-channel feature map
    k = 3
    sep_w = (channels * k * k + channels * channels) * dtype_bytes  # dw + pw
    specs: list[dict] = []
    specs.append(dict(name="c_{k-2}", op="input", size_bytes=fmap, preds=[],
                      weight_bytes=0))
    specs.append(dict(name="c_{k-1}", op="input", size_bytes=fmap, preds=[],
                      weight_bytes=0))
    cc = _add_cell(specs, 0, 1, fmap=fmap, sep_w=sep_w)
    # cells are followed by a 1x1 conv when channels change; model the
    # downstream consumer so concat liveness is realistic:
    specs.append(dict(name="next.pw", op="conv", size_bytes=fmap, preds=[cc],
                      weight_bytes=4 * channels * channels * dtype_bytes))
    return Graph.build(specs, name="darts_imagenet_cell")


def darts_network(
    n_cells: int = 6,
    hw: int = 28,
    channels: int = 48,
    dtype_bytes: int = 4,
    double_skip: bool = False,
) -> Graph:
    """The deployed DARTS form: one normal cell repeated ``n_cells`` times.

    Every cell's concat feeds a 1x1 transition conv whose output is the next
    cell's input, so with ``double_skip=False`` each transition is a
    single-node separator and the partition tree reduces the network to
    ``n_cells`` isomorphic leaves — scheduled once, replayed for the rest.
    ``double_skip=True`` additionally feeds each cell its grandparent's
    transition output (the published genotype's ``c_{k-2}`` input): two
    tensors then stay live across every boundary, no separator exists, and
    the whole network is a single exact-search cell (branch-and-bound
    stress case; expect the soft-budget/beam machinery at realistic sizes).

    ``n_cells=6`` gives a 207-node chain (``double_skip`` adds no nodes,
    only edges).
    """
    fmap = hw * hw * channels * dtype_bytes
    k = 3
    sep_w = (channels * k * k + channels * channels) * dtype_bytes
    specs: list[dict] = []
    specs.append(dict(name="stem", op="input", size_bytes=fmap, preds=[],
                      weight_bytes=0))
    prev_prev = prev = 0
    for ci in range(n_cells):
        in0 = prev_prev if double_skip else prev
        cc = _add_cell(specs, in0, prev, fmap=fmap, sep_w=sep_w,
                       tag=f"c{ci}.")
        specs.append(dict(name=f"c{ci}.trans.pw", op="conv", size_bytes=fmap,
                          preds=[cc],
                          weight_bytes=4 * channels * channels * dtype_bytes))
        prev_prev, prev = prev, len(specs) - 1
    tag = "skip" if double_skip else "chain"
    return Graph.build(specs, name=f"darts_net_x{n_cells}_{tag}")
