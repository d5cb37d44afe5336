from .docstore import TsvDocStore
from .label_modes import LABEL_MODES, labels_for, nway_for
from .loaders import (
    iter_jsonl,
    load_passages,
    load_queries,
    load_train_examples,
    passage_text,
)
from .nway_dataset import NwayBatch, NwayDataset
from .packing import PackedBatch, pack_nway_batch
from .prefetch import prefetch
from .reranking_dataset import RerankBatch, RerankingDataset
from .sequence_dataset import SequenceBatch, SequenceDataset
from .teacher import (
    CURRICULUM_BUCKETS,
    bucket_example,
    build_curriculum_files,
    rerank_candidates_with_teacher,
)
from .tokenization import HashTokenizer, HFTokenizerAdapter

__all__ = ["CURRICULUM_BUCKETS", "HashTokenizer", "HFTokenizerAdapter",
           "LABEL_MODES", "NwayBatch", "NwayDataset", "PackedBatch",
           "RerankBatch", "RerankingDataset", "SequenceBatch",
           "SequenceDataset", "TsvDocStore", "bucket_example",
           "build_curriculum_files", "iter_jsonl", "labels_for",
           "load_passages", "load_queries", "load_train_examples",
           "nway_for", "pack_nway_batch", "passage_text", "prefetch",
           "rerank_candidates_with_teacher"]
