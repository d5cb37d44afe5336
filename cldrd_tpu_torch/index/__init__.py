from .builder import (
    build_index_from_dataset,
    build_index_on_device,
    encode_dataset,
    make_encode_fn,
)
from .flat_index import FlatIPIndex, query_dtype_for, quantize_rows
from .ivf_index import IVFIndex, ivf_exists
from .kmeans import assign_clusters, kmeans
from .persistence import (
    index_exists,
    load_index,
    read_embeddings,
    write_embeddings,
)
from .refine import DiskRefiner, RefinedIndex

__all__ = ["DiskRefiner", "FlatIPIndex", "IVFIndex", "RefinedIndex",
           "assign_clusters", "build_index_from_dataset",
           "build_index_on_device", "encode_dataset", "index_exists", "ivf_exists",
           "kmeans", "load_index", "make_encode_fn", "query_dtype_for",
           "quantize_rows", "read_embeddings", "write_embeddings"]
