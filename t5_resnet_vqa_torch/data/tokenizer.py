"""Tokenizers for the question/answer text path (encoding and decoding, as
the JAX package's ``data/tokenizer.py``; ``transformers`` stays a lazy
import).

The reference builds an HF ``AutoTokenizer.from_pretrained("t5-base")`` inside
each collate and registers 3 + 11 extra special tokens WITHOUT resizing the
model embedding — the new ids land in t5's 32100..32127 padding rows
(resnet_vqa_daquar_dataset.py:113-129, SURVEY §2 C8). This module keeps that
contract:

  * ``HFTokenizer`` — wraps the real HF tokenizer when its files are cached
    locally (offline machines usually have none).
  * ``TokenizerFileTokenizer`` — a user-supplied ``tokenizer.json`` read
    by the ``tokenizers`` runtime (real ids offline).
  * ``HashTokenizer`` — deterministic offline fallback with the same API and
    id layout: pad=0, eos=1 (</s>), unk=2, word ids hashed into
    [1000, 32000), special tokens pinned at 32100+ in the reference's
    registration order. Same text always maps to the same ids, so training
    and eval are reproducible without the sentencepiece model.

Both produce fixed-shape int32 [B, max_length] id/mask arrays (static
shapes; the reference's ``padding="longest"`` ViT-path questions are padded
to QUESTION_MAX_LEN=16 instead — a documented divergence).
"""

from __future__ import annotations

import hashlib
import re
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..core import constants

SPECIAL_TOKENS = (
    constants.QUESTION_SPECIAL_TOKEN,
    constants.ANSWER_SPECIAL_TOKEN,
    constants.QUESTION_TYPE_SPECIAL_TOKEN,
) + constants.QUESTION_TYPE_TOKENS


class HashTokenizer:
    """Offline deterministic tokenizer with the HF call surface we use.

    Free-text words hash into [1000, 32000); by birthday statistics a few
    hundred distinct words already make a collision likely (observed:
    "vase" and "book" share a bucket), which would silently merge token
    semantics. Collisions between ANSWER-SPACE words are the dangerous
    case — they alias label words the classifier must distinguish — so
    words appearing in ``pinned_words`` (the collates pass their answer
    space) get collision-free ids from the reserved range [100, 1000),
    assigned in sorted order. The assignment is deterministic given the
    same answer space, which is part of the checkpoint contract
    (model_ckpt_info.json), so train/eval/serving agree across processes.
    """

    pad_token_id = constants.PAD_TOKEN_ID
    eos_token_id = constants.EOS_TOKEN_ID
    unk_token_id = 2

    _WORD_RE = re.compile(r"[a-zA-Z0-9']+|[^\sa-zA-Z0-9]")
    _PINNED_BASE = 100
    _PINNED_CAP = 1000

    def __init__(self, vocab_size: int = constants.T5_VOCAB_SIZE,
                 pinned_words: Optional[Sequence[str]] = None):
        self.vocab_size = vocab_size
        self.special_to_id = {
            tok: constants.T5_FIRST_EXTRA_ID + i
            for i, tok in enumerate(SPECIAL_TOKENS)
        }
        self.id_to_special = {v: k for k, v in self.special_to_id.items()}
        self._special_re = re.compile(
            "(" + "|".join(re.escape(t) for t in SPECIAL_TOKENS) + ")")
        self.pinned: dict = {}
        self.scheme = "hash-v1"          # id-layout version (ckpt contract)
        if pinned_words:
            self.scheme = "hash-v2-pinned"
            words = sorted({w.lower() for entry in pinned_words
                            for w in self._WORD_RE.findall(entry)})
            if self._PINNED_BASE + len(words) > self._PINNED_CAP:
                raise ValueError(
                    f"{len(words)} pinned words exceed the reserved id range "
                    f"[{self._PINNED_BASE}, {self._PINNED_CAP})")
            self.pinned = {w: self._PINNED_BASE + i
                           for i, w in enumerate(words)}

    def _word_id(self, word: str) -> int:
        word = word.lower()
        pinned = self.pinned.get(word)
        if pinned is not None:
            return pinned
        h = int.from_bytes(
            hashlib.md5(word.encode()).digest()[:4], "little")
        return 1000 + h % 31000

    def _tokenize(self, text: str) -> List[int]:
        ids: List[int] = []
        for chunk in self._special_re.split(text):
            if not chunk:
                continue
            if chunk in self.special_to_id:
                ids.append(self.special_to_id[chunk])
            else:
                ids.extend(self._word_id(w)
                           for w in self._WORD_RE.findall(chunk))
        return ids

    def __call__(self, texts: Sequence[str], max_length: int,
                 padding: str = "max_length",
                 truncation: bool = True) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (input_ids, attention_mask) int32 [B, max_length].

        T5 semantics: sequence is closed with </s> (eos), then padded with 0.
        """
        B = len(texts)
        ids = np.full((B, max_length), self.pad_token_id, np.int32)
        mask = np.zeros((B, max_length), np.int32)
        for i, text in enumerate(texts):
            toks = self._tokenize(text)
            toks = toks[: max_length - 1] + [self.eos_token_id]
            ids[i, : len(toks)] = toks
            mask[i, : len(toks)] = 1
        return ids, mask

    def decode_specials(self, ids: Sequence[int]) -> List[str]:
        return [self.id_to_special.get(int(i), f"<{int(i)}>") for i in ids]

    def decode(self, ids: Sequence[int],
               skip_special_tokens: bool = True) -> str:
        """Hashed word ids are not invertible: generated tokens surface as
        ``<id>`` placeholders and special tokens decode by name. Real text
        needs the HF tokenizer."""
        parts = []
        for i in ids:
            i = int(i)
            if i in (self.pad_token_id, self.eos_token_id):
                if not skip_special_tokens:
                    parts.append("</s>" if i == self.eos_token_id else "<pad>")
                continue
            sp = self.id_to_special.get(i)
            if sp is not None:
                if not skip_special_tokens:
                    parts.append(sp)
                continue
            parts.append(f"<{i}>")
        return " ".join(parts)


class HFTokenizer:
    """HF AutoTokenizer adapter with the reference's special-token setup."""

    def __init__(self, lang_model: str = "t5-base"):
        from transformers import AutoTokenizer  # deferred: needs cached files

        # local_files_only: fail fast when no cache (offline machines)
        self.tok = AutoTokenizer.from_pretrained(lang_model,
                                                 local_files_only=True)
        # reference registration order (resnet_vqa_daquar_dataset.py:121-129)
        self.tok.add_special_tokens({"additional_special_tokens": [
            constants.QUESTION_SPECIAL_TOKEN,
            constants.ANSWER_SPECIAL_TOKEN,
            constants.QUESTION_TYPE_SPECIAL_TOKEN,
        ]})
        self.tok.add_special_tokens({"additional_special_tokens":
                                     list(constants.QUESTION_TYPE_TOKENS)})
        self.pad_token_id = self.tok.pad_token_id
        self.eos_token_id = self.tok.eos_token_id
        self.vocab_size = constants.T5_VOCAB_SIZE
        self.scheme = f"hf:{lang_model}"

    def __call__(self, texts: Sequence[str], max_length: int,
                 padding: str = "max_length",
                 truncation: bool = True) -> Tuple[np.ndarray, np.ndarray]:
        out = self.tok(list(texts), return_tensors="np", padding="max_length",
                       truncation=truncation, max_length=max_length)
        return (out["input_ids"].astype(np.int32),
                out["attention_mask"].astype(np.int32))

    def decode(self, ids: Sequence[int],
               skip_special_tokens: bool = True) -> str:
        return self.tok.decode([int(i) for i in ids],
                               skip_special_tokens=skip_special_tokens)


class TokenizerFileTokenizer:
    """Real-vocabulary tokenizer from a user-supplied ``tokenizer.json``.

    The offline path to real ids: without sentencepiece or an HF cache, the
    ``tokenizers`` (fast) runtime reads t5-base's ``tokenizer.json`` from
    next to the data and gives the exact sentencepiece ids the reference's
    embeddings were trained on (config key ``dataset_kwargs.tokenizer_file``).

    Special tokens are registered in the reference's order
    (resnet_vqa_daquar_dataset.py:121-129); for t5-base's 32100-entry
    tokenizer.json they land on ids 32100..32113 — inside the model's 32128
    embedding rows, same as the reference's un-resized registration.
    """

    def __init__(self, tokenizer_file: str):
        from tokenizers import Tokenizer  # deferred import

        self.tok = Tokenizer.from_file(tokenizer_file)
        self.tok.add_special_tokens(list(SPECIAL_TOKENS))
        pad = self.tok.token_to_id("<pad>")
        eos = self.tok.token_to_id("</s>")
        self.pad_token_id = constants.PAD_TOKEN_ID if pad is None else pad
        self.eos_token_id = constants.EOS_TOKEN_ID if eos is None else eos
        self.vocab_size = max(self.tok.get_vocab_size(),
                              constants.T5_VOCAB_SIZE)
        self.scheme = "tokenizer-file"

    def __call__(self, texts: Sequence[str], max_length: int,
                 padding: str = "max_length",
                 truncation: bool = True) -> Tuple[np.ndarray, np.ndarray]:
        self.tok.enable_truncation(max_length)
        self.tok.enable_padding(length=max_length,
                                pad_id=self.pad_token_id, pad_token="<pad>")
        encs = self.tok.encode_batch(list(texts))
        ids = np.asarray([e.ids for e in encs], np.int32)
        mask = np.asarray([e.attention_mask for e in encs], np.int32)
        return ids, mask

    def decode(self, ids: Sequence[int],
               skip_special_tokens: bool = True) -> str:
        return self.tok.decode([int(i) for i in ids],
                               skip_special_tokens=skip_special_tokens)


def get_tokenizer(lang_model: str = "t5-base",
                  tokenizer_file: Optional[str] = None,
                  pinned_words: Optional[Sequence[str]] = None):
    """Best available real tokenizer:

    1. a user-supplied ``tokenizer.json`` (real vocabulary, works offline),
    2. HF AutoTokenizer when its files are cached locally,
    3. HashTokenizer (deterministic offline fallback; ``pinned_words`` —
       typically the answer space — get collision-free ids)."""
    if tokenizer_file:
        return TokenizerFileTokenizer(tokenizer_file)
    try:
        return HFTokenizer(lang_model)
    except (ImportError, OSError, ValueError):
        # no transformers, or no locally cached tokenizer files
        return HashTokenizer(pinned_words=pinned_words)
