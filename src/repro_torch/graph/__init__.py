from repro_torch.graph.csr import Graph, expand_seed_edges, from_coo
from repro_torch.graph.generators import (
    PAPER_DATASETS,
    DatasetSpec,
    GraphDataset,
    generate,
    paper_dataset,
)

__all__ = [
    "Graph", "expand_seed_edges", "from_coo", "PAPER_DATASETS",
    "DatasetSpec", "GraphDataset", "generate", "paper_dataset",
]
