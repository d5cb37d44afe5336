from .mips import (
    topk_binmax,
    topk_dense,
    topk_streaming,
    topk_with_payload_chunked,
)
from .run_writer import retrieve_to_run_file, write_run_file

__all__ = ["retrieve_to_run_file", "topk_binmax", "topk_dense",
           "topk_streaming", "topk_with_payload_chunked", "write_run_file"]
