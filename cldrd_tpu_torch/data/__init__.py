from .loaders import load_passages, load_queries, passage_text
from .sequence_dataset import SequenceBatch, SequenceDataset
from .tokenization import HashTokenizer, HFTokenizerAdapter

__all__ = ["HashTokenizer", "HFTokenizerAdapter", "SequenceBatch",
           "SequenceDataset", "load_passages", "load_queries",
           "passage_text"]
