from .graph import CSRGraph
from .subgraphs import read_subgraphs, MultiLabelBinarizer
from .dataset import SubgraphData, initialize_cc_ids

__all__ = [
    "CSRGraph",
    "read_subgraphs",
    "MultiLabelBinarizer",
    "SubgraphData",
    "initialize_cc_ids",
]
