"""Graph representation, loaders, and generators (SURVEY.md §2 #5, #7-#11)."""

from paralleljohnson_tpu_torch.graphs.csr import (
    CSRGraph,
    EdgeUpdateReport,
    PAD_WEIGHT,
    stack_graphs,
)
from paralleljohnson_tpu_torch.graphs.generators import (
    erdos_renyi,
    grid2d,
    permute_labels,
    random_dag,
    random_graph_batch,
    rmat,
)
from paralleljohnson_tpu_torch.graphs.loaders import (
    GraphFormatError,
    load_dimacs,
    load_snap,
    save_dimacs,
)
from paralleljohnson_tpu_torch.graphs.registry import (
    available_loaders,
    load_graph,
    register_loader,
)

__all__ = [
    "CSRGraph",
    "EdgeUpdateReport",
    "GraphFormatError",
    "PAD_WEIGHT",
    "available_loaders",
    "erdos_renyi",
    "grid2d",
    "load_dimacs",
    "load_graph",
    "load_snap",
    "permute_labels",
    "random_dag",
    "random_graph_batch",
    "register_loader",
    "rmat",
    "save_dimacs",
    "stack_graphs",
]
