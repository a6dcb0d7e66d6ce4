from repro_torch.graph.csr import (Graph, expand_seed_edges, from_coo,
                                   reverse)
from repro_torch.graph.generators import (
    PAPER_DATASETS,
    DatasetSpec,
    GraphDataset,
    generate,
    paper_dataset,
)

__all__ = [
    "Graph", "expand_seed_edges", "from_coo", "reverse", "PAPER_DATASETS",
    "DatasetSpec", "GraphDataset", "generate", "paper_dataset",
]
