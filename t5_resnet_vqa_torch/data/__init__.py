"""Host-side data path: records and datasets (DAQUAR, OK-VQA), the answer
space, tokenizer, images, the CNN, ViT and Kimi-VL collates, batching and prefetch,
synthetic data."""

from .answer_space import build_answer_space, write_answer_space
from .collate import (
    DaquarCnnCollate,
    DaquarCollateBase,
    DaquarVitCollate,
    KimiVLCollate,
)
from .daquar import (
    Annotation,
    DaquarDataset,
    Question,
    Sample,
    load_answer_spaces,
)
from .okvqa import (
    OKVQADataset,
    OkVqaAnnotation,
    OkVqaCollate,
    OkVqaSample,
    OkVqaTrainableDataset,
)
from .pipeline import DataLoader, Prefetcher, to_device
from .synthetic import make_synthetic_daquar, make_synthetic_okvqa
from .tokenizer import HashTokenizer, get_tokenizer

__all__ = [
    "Annotation", "DaquarCnnCollate", "DaquarCollateBase", "DaquarDataset",
    "DaquarVitCollate", "DataLoader", "HashTokenizer", "KimiVLCollate",
    "OKVQADataset",
    "OkVqaAnnotation", "OkVqaCollate", "OkVqaSample", "OkVqaTrainableDataset",
    "Prefetcher", "Question", "Sample", "build_answer_space",
    "get_tokenizer", "load_answer_spaces", "make_synthetic_daquar",
    "make_synthetic_okvqa", "to_device", "write_answer_space",
]
