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
from .sequence_dataset import SequenceBatch, SequenceDataset
from .tokenization import HashTokenizer, HFTokenizerAdapter

__all__ = ["HashTokenizer", "HFTokenizerAdapter", "LABEL_MODES",
           "NwayBatch", "NwayDataset", "PackedBatch", "SequenceBatch",
           "SequenceDataset", "iter_jsonl", "labels_for", "load_passages",
           "load_queries", "load_train_examples", "nway_for",
           "pack_nway_batch", "passage_text", "prefetch"]
