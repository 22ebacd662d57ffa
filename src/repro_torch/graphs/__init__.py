"""Benchmark graph generators for the paper's evaluation networks.

darts     -- DARTS learned normal cell (Liu et al., 2019), ImageNet config
swiftnet  -- SwiftNet cells (Zhang et al., 2019), HPD config (reconstructed)
randwire  -- RandWire WS random graphs (Xie et al., 2019), CIFAR configs

``BENCHMARK_GRAPHS`` are the paper's single-cell workloads (every tier-1
engine-parity test runs the exact DP on each of them).  ``FULL_NETWORKS``
are the stacked ≥200-node deployments — RandWire with 8 repeated WS(32)
stages, DARTS with 6 repeated normal cells — that exercise the hierarchical
partition + isomorphic-cell reuse path end to end; they are benchmark-only
(a flat exact DP cannot finish them, which is the point).
"""

from repro_torch.graphs.darts import darts_network, darts_normal_cell
from repro_torch.graphs.randwire import randwire_graph, randwire_network
from repro_torch.graphs.swiftnet import swiftnet_cell, swiftnet_network

BENCHMARK_GRAPHS = {
    "darts_imagenet_cell": lambda: darts_normal_cell(),
    "swiftnet_cell_a": lambda: swiftnet_cell("A"),
    "swiftnet_cell_b": lambda: swiftnet_cell("B"),
    "swiftnet_cell_c": lambda: swiftnet_cell("C"),
    "randwire_cifar10": lambda: randwire_graph(seed=10),
    "randwire_cifar100": lambda: randwire_graph(seed=100),
}

FULL_NETWORKS = {
    "randwire_net_32x8": lambda: randwire_network(n_cells=8, n=32),
    "darts_net_x6": lambda: darts_network(n_cells=6),
}

__all__ = [
    "BENCHMARK_GRAPHS",
    "FULL_NETWORKS",
    "darts_network",
    "darts_normal_cell",
    "randwire_graph",
    "randwire_network",
    "swiftnet_cell",
    "swiftnet_network",
]
