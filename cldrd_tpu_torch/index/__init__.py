from .builder import encode_dataset, make_encode_fn
from .flat_index import FlatIPIndex, query_dtype_for, quantize_rows
from .persistence import (
    index_exists,
    load_index,
    read_embeddings,
    write_embeddings,
)

__all__ = ["FlatIPIndex", "encode_dataset", "index_exists", "load_index",
           "make_encode_fn", "query_dtype_for", "quantize_rows",
           "read_embeddings", "write_embeddings"]
