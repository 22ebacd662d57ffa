"""SwiftNet cells (Zhang et al., 2019) as SERENITY graphs — reconstructed.

SwiftNet's exact cell wiring is not published as a machine-readable genotype;
we reconstruct cells with the node counts the paper reports in Table 2
(62 nodes = {21, 19, 22}) and the structure its Fig. 3(a) shows: several
depthwise-separable branches with *irregular cross-branch skip wiring*, all
merged by one wide concatenation feeding a 1x1 convolution.  Absolute KB
therefore differ from the paper; the *ratios* (DP vs. Kahn/TFLite order,
rewriting delta) are the validated quantities — see EXPERIMENTS.md
§Paper-validation.

HPD input regime: 112x112 grayscale; cell A runs at 56x56 with few channels.
"""

from __future__ import annotations

from repro_torch.core.graph import Graph


def _cell(
    name: str,
    hw: int,
    cin: int,
    branch_specs: list[list[int]],
    cross_edges: list[tuple[int, int, int, int]],
    dtype_bytes: int = 4,
) -> Graph:
    """Build one cell.

    ``branch_specs``  per-branch list of channel widths; stage = depthconv
                      followed by a 1x1 conv at that width (dw-separable).
    ``cross_edges``   (src_branch, src_stage, dst_branch, dst_stage) skip
                      links: the dst stage's dwconv additionally sums the src
                      stage's output (irregular wiring — requires matching
                      widths; the builder adds an `add` node).
    All branches merge in ONE wide concat -> 1x1 conv (the paper's memory-
    pressure pattern, Fig. 9).
    """
    specs: list[dict] = []

    def add(name_, op, size, preds=(), weight=0):
        specs.append(
            dict(name=name_, op=op, size_bytes=int(size), preds=list(preds),
                 weight_bytes=int(weight))
        )
        return len(specs) - 1

    px = hw * hw * dtype_bytes
    expand = 6  # MobileNetV2/SwiftNet inverted-residual expansion factor
    inp = add("in", "input", px * cin)
    stage_out: dict[tuple[int, int], tuple[int, int]] = {}  # (b,s) -> (id, ch)
    cross_by_dst: dict[tuple[int, int], list[tuple[int, int]]] = {}
    for sb, ss, db, ds in cross_edges:
        cross_by_dst.setdefault((db, ds), []).append((sb, ss))

    # build stages in dependency order (cross edges may point "forward"
    # between branches, so round-robin until every stage is placed)
    cursor = {b: (inp, cin, 0) for b in range(len(branch_specs))}
    remaining = sum(len(w) for w in branch_specs)
    while remaining:
        progressed = False
        for b, widths in enumerate(branch_specs):
            x, ch, s = cursor[b]
            if s >= len(widths):
                continue
            srcs = cross_by_dst.get((b, s), ())
            if any((sb, ss) not in stage_out for (sb, ss) in srcs):
                continue
            w = widths[s]
            if srcs:
                # weighted-sum join of same-resolution feature maps
                pred_ids = [x] + [stage_out[(sb, ss)][0] for (sb, ss) in srcs]
                x = add(f"b{b}.s{s}.join", "add", px * ch, pred_ids)
            # inverted residual: expand 1x1 -> depthwise -> project 1x1
            hidden = ch * expand
            e = add(f"b{b}.s{s}.expand", "conv", px * hidden, [x],
                    weight=ch * hidden * dtype_bytes)
            d = add(f"b{b}.s{s}.dw", "depthconv", px * hidden, [e],
                    weight=hidden * 9 * dtype_bytes)
            x = add(f"b{b}.s{s}.pw", "conv", px * w, [d],
                    weight=hidden * w * dtype_bytes)
            ch = w
            stage_out[(b, s)] = (x, ch)
            cursor[b] = (x, ch, s + 1)
            remaining -= 1
            progressed = True
        if not progressed:
            raise ValueError("cyclic cross_edges")
    for b, widths in enumerate(branch_specs):
        x, ch, _ = cursor[b]
        stage_out[(b, "out")] = (x, ch)

    concat_in = [stage_out[(b, "out")][0] for b in range(len(branch_specs))]
    cout = sum(stage_out[(b, "out")][1] for b in range(len(branch_specs)))
    cc = add("cell.concat", "concat", px * cout, concat_in)
    add("out.pw", "conv", px * cin, [cc], weight=cout * cin * dtype_bytes)
    return Graph.build(specs, name=name)


def swiftnet_cell(which: str = "A", dtype_bytes: int = 4) -> Graph:
    """Cells A/B/C with node counts 21/19/22 (paper Table 2)."""
    # node count = 1(in) + 3*sum(stages) + len(cross_edges) + 1(concat) + 1(out)
    if which == "A":
        # 1 + 3*5 + 3 + 2 = 21
        return _cell(
            "swiftnet_cell_a", hw=56, cin=16,
            branch_specs=[[16, 24], [16], [24], [16]],
            cross_edges=[(1, 0, 0, 0), (1, 0, 0, 1), (3, 0, 2, 0)],
            dtype_bytes=dtype_bytes,
        )
    if which == "B":
        # 1 + 3*5 + 1 + 2 = 19
        return _cell(
            "swiftnet_cell_b", hw=28, cin=32,
            branch_specs=[[32, 48], [32], [48], [32]],
            cross_edges=[(1, 0, 0, 1)],
            dtype_bytes=dtype_bytes,
        )
    if which == "C":
        # 1 + 3*6 + 1 + 2 = 22
        return _cell(
            "swiftnet_cell_c", hw=14, cin=64,
            branch_specs=[[64, 96], [64, 96], [96], [64]],
            cross_edges=[(1, 0, 0, 1)],
            dtype_bytes=dtype_bytes,
        )
    raise ValueError(which)


def swiftnet_network(dtype_bytes: int = 4) -> Graph:
    """All three cells chained (62 nodes): the Table 2 whole-network case."""
    cells = [swiftnet_cell(w, dtype_bytes) for w in ("A", "B", "C")]
    specs: list[dict] = []
    offset = 0
    prev_out: int | None = None
    for ci, cell in enumerate(cells):
        for nd in cell.nodes:
            preds = [p + offset for p in nd.preds]
            if nd.op == "input" and prev_out is not None:
                # stitch: the cell input becomes a strided depthconv of the
                # previous cell's output (downsampling transition).
                specs.append(
                    dict(name=f"c{ci}.{nd.name}", op="depthconv",
                         size_bytes=nd.size_bytes, preds=[prev_out],
                         weight_bytes=9 * dtype_bytes * 64)
                )
            else:
                specs.append(
                    dict(name=f"c{ci}.{nd.name}", op=nd.op,
                         size_bytes=nd.size_bytes, preds=preds,
                         alias_preds=set(nd.alias_preds),
                         weight_bytes=nd.weight_bytes)
                )
        prev_out = offset + len(cell) - 1
        offset += len(cell)
    return Graph.build(specs, name="swiftnet_62")
