"""Host-side data path: records and dataset, tokenizer, images, the CNN and
ViT collates, batching and prefetch, synthetic data."""

from .collate import DaquarCnnCollate, DaquarCollateBase, DaquarVitCollate
from .daquar import (
    Annotation,
    DaquarDataset,
    Question,
    Sample,
    load_answer_spaces,
)
from .pipeline import DataLoader, Prefetcher, to_device
from .synthetic import make_synthetic_daquar
from .tokenizer import HashTokenizer, get_tokenizer

__all__ = [
    "Annotation", "DaquarCnnCollate", "DaquarCollateBase", "DaquarDataset",
    "DaquarVitCollate", "DataLoader", "HashTokenizer", "Prefetcher",
    "Question", "Sample", "get_tokenizer", "load_answer_spaces",
    "make_synthetic_daquar", "to_device",
]
