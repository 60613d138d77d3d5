"""Host-side data path of the CNN family: records, tokenizer, images,
collate."""

from .collate import DaquarCnnCollate, DaquarCollateBase
from .daquar import Annotation, Question, Sample
from .tokenizer import HashTokenizer, get_tokenizer

__all__ = [
    "Annotation", "DaquarCnnCollate", "DaquarCollateBase", "HashTokenizer",
    "Question", "Sample", "get_tokenizer",
]
