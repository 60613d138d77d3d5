"""Batch collates: raw DAQUAR samples -> fixed-shape numpy feeds (the JAX
package's ``DaquarCollateBase``, ``DaquarCnnCollate`` and ``DaquarVitCollate``).

Text and labels, shared by both families: question "[Question] {q}" padded
to 16; decoder text "+ [Answer]" and answers padded to 20; label = a
randomly chosen answer's index in the answer space (out-of-vocabulary
answers fall back to the 'O' class), drawn from a seeded numpy Generator.
Images, per family: cv2 decode -> RGB -> resize (in fp32 through the
native library for a bilinear float batch with ``use_native``), then

  * CNN: 256^2 with the configured interpolation, ToTensor only
    (unnormalized), key ``image_tensors``;
  * ViT: 224^2 bilinear, rescaled 1/255 then normalized with mean = std =
    0.5 (the in21k ViT image processor), key ``pixel_values``;

or the resized uint8 batch with ``emit_uint8``, which the model scales (and
normalizes) on the device. ``reduced_decode`` and ``num_workers`` are the
loader's ``reduce`` and ``workers`` (``data/preprocessing.py``).

``KimiVLCollate`` (the ``kimi_vl`` family, which generates its answers)
builds Kimi-VL chat prompts around the image placeholders and pads the
uint8 images, at their own size, to multiples of the patch merge.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from ..core import constants
from ..utils.profiling import span
from .daquar import Sample
from .preprocessing import load_image_batch
from .tokenizer import HashTokenizer, get_tokenizer


class DaquarCollateBase:
    """Text, labels and the image pipeline's frame; a family sets the image
    size, interpolation, normalization and batch key."""

    images_key = "image_tensors"
    normalize: Optional[Tuple[Sequence[float], Sequence[float]]] = None

    def __init__(
        self,
        answer_spaces: Sequence[str],
        lang_model: str = "t5-base",
        eval_mode: bool = False,
        seed: int = 0,
        tokenizer=None,
        use_native: bool = True,
        emit_uint8: bool = False,
        reduced_decode: int = 0,
        num_workers: int = 0,
    ):
        self.answer_spaces = [a.strip("\n") for a in answer_spaces]
        self._answer_index = {a: i for i, a in enumerate(self.answer_spaces)}
        self.eval_mode = eval_mode
        # answer-space words get collision-free ids in the hash fallback
        self.tokenizer = tokenizer or get_tokenizer(
            lang_model, pinned_words=self.answer_spaces)
        self.question_max_len = constants.QUESTION_MAX_LEN
        self.decoder_max_len = constants.MAX_LEN
        self.rng = np.random.default_rng(seed)
        self._oov_index = self._answer_index.get("O", 0)
        # False: batches carry no image array (decode and resize skipped)
        self.emit_images = True
        self.use_native = use_native
        self.emit_uint8 = emit_uint8
        self.reduced_decode = reduced_decode
        self.num_workers = num_workers
        self.resizing_dimensions = (constants.CNN_IMAGE_SIZE,
                                    constants.CNN_IMAGE_SIZE)
        self.interpolation_strategy = "bilinear_interpolation"

    def _labels(self, samples: Sequence[Sample]):
        """Pick one answer per sample (fresh each call) and map to ids."""
        chosen: List[str] = []
        ids = np.empty(len(samples), np.int32)
        for i, s in enumerate(samples):
            answers = s.annotation.answers
            a = answers[int(self.rng.integers(len(answers)))]
            chosen.append(a)
            ids[i] = self._answer_index.get(a, self._oov_index)
        return ids, chosen

    def _text_feeds(self, samples: Sequence[Sample], chosen: List[str]):
        q_texts = [f"{constants.QUESTION_SPECIAL_TOKEN} "
                   f"{s.question.question_text}" for s in samples]
        d_texts = [f"{constants.QUESTION_SPECIAL_TOKEN} "
                   f"{s.question.question_text} "
                   f"{constants.ANSWER_SPECIAL_TOKEN}" for s in samples]
        q_ids, q_mask = self.tokenizer(q_texts, self.question_max_len)
        d_ids, d_mask = self.tokenizer(d_texts, self.decoder_max_len)
        a_ids, a_mask = self.tokenizer(chosen, constants.MAX_LEN)
        return q_ids, q_mask, d_ids, d_mask, a_ids, a_mask

    def _assemble(self, samples, images_key, images):
        annotation_ids, chosen = self._labels(samples)
        with span("collate.text"):
            q_ids, q_mask, d_ids, d_mask, a_ids, a_mask = self._text_feeds(
                samples, chosen)
        batch: Dict[str, np.ndarray] = {
            "question_input_ids": q_ids,
            "decoder_question_input_ids": d_ids,
            "question_attention_masks": q_mask,
            "decoder_question_attention_masks": d_mask,
            "annotation_ids": annotation_ids,
            "answer_input_ids": a_ids,
            "answer_attention_masks": a_mask,
        }
        if images is not None:
            batch[images_key] = images
        if self.eval_mode:
            batch["answers"] = [s.annotation.answers for s in samples]
            batch["questions"] = [s.question for s in samples]
            batch["image_fns"] = [s.image_path for s in samples]
        return batch

    def load_images(self, paths: Sequence[str]) -> np.ndarray:
        """[B, H, W, 3] float32 (normalized where the family normalizes),
        or resized uint8 with ``emit_uint8`` (the model scales and
        normalizes on the device)."""
        return load_image_batch(
            list(paths), self.resizing_dimensions,
            self.interpolation_strategy, normalize=self.normalize,
            use_native=self.use_native, emit_uint8=self.emit_uint8,
            reduce=self.reduced_decode, workers=self.num_workers)

    def __call__(self, samples: Sequence[Sample]) -> Dict[str, np.ndarray]:
        images = None
        if self.emit_images:
            # the range sits at the call, so it also covers a
            # ``load_images`` that an instance replaces
            with span("collate.images"):
                images = self.load_images([s.image_path for s in samples])
        return self._assemble(samples, self.images_key, images)


class DaquarCnnCollate(DaquarCollateBase):
    """CNN-family collate (reference DaquarFasterRcnnT5CollateFn)."""

    def __init__(self, answer_spaces: Sequence[str],
                 interpolation_strategy: str = "bilinear_interpolation",
                 resizing_dimensions=(constants.CNN_IMAGE_SIZE,
                                      constants.CNN_IMAGE_SIZE),
                 lang_model: str = "t5-base", eval_mode: bool = False,
                 seed: int = 0, tokenizer=None, use_native: bool = True,
                 emit_uint8: bool = False, reduced_decode: int = 0,
                 num_workers: int = 0):
        super().__init__(answer_spaces, lang_model, eval_mode, seed,
                         tokenizer, use_native, emit_uint8, reduced_decode,
                         num_workers)
        self.interpolation_strategy = interpolation_strategy
        self.resizing_dimensions = tuple(resizing_dimensions)


class DaquarVitCollate(DaquarCollateBase):
    """ViT-family collate (reference DaquarVitT5CollateFn): 224^2 bilinear,
    pixel values rescaled 1/255 then normalized with mean = std = 0.5."""

    images_key = "pixel_values"
    normalize = (constants.VIT_IMAGE_MEAN, constants.VIT_IMAGE_STD)

    def __init__(self, answer_spaces: Sequence[str],
                 lang_model: str = "t5-base", eval_mode: bool = False,
                 seed: int = 0, tokenizer=None, use_native: bool = True,
                 emit_uint8: bool = False, reduced_decode: int = 0,
                 num_workers: int = 0):
        super().__init__(answer_spaces, lang_model, eval_mode, seed,
                         tokenizer, use_native, emit_uint8, reduced_decode,
                         num_workers)
        self.resizing_dimensions = (constants.VIT_IMAGE_SIZE,
                                    constants.VIT_IMAGE_SIZE)


class KimiVLCollate:
    """(image path, question) requests -> Kimi-VL prompts and images.

    Each image is decoded at ``image_size`` (H, W; DAQUAR's NYU frames are
    480 x 640) as uint8 and padded with zeros at the bottom and right to
    multiples of ``patch * merge`` pixels (504 x 644: 36 x 46 patches,
    414 image tokens). The prompt is Kimi-VL's chat turn

        <|im_user|> user <|im_middle|> <|media_start|> image
        <|media_content|> <|media_pad|> x n <|media_end|> {question}
        <|im_end|> <|im_assistant|> assistant <|im_middle|>

    with the words through ``tokenizer`` (at most ``max_question_tokens``
    of the question), padded on the right with ``pad`` to one length for
    every batch. The special ids are ``special_tokens`` over
    ``SPECIAL_TOKENS``, those assumed of Kimi-VL's tokenizer (its
    ``<|media_pad|>`` is the published ``media_placeholder_token_id``);
    ``eos`` (``<|im_end|>``) ends an answer.

    ``__call__(requests, batch)`` -> ``input_ids`` int64 [batch, L],
    ``lengths`` int64 [batch], ``pixel_values`` uint8 [batch, H', W', 3];
    rows past the requests repeat the first.
    """

    SPECIAL_TOKENS = {"im_end": 163586, "im_user": 163587,
                      "im_assistant": 163588, "im_middle": 163601,
                      "media_start": 163602, "media_content": 163603,
                      "media_end": 163604, "media_pad": 163605, "pad": 163839}

    def __init__(self, tokenizer=None, image_size=(480, 640),
                 patch_size: int = 14, merge: int = 2,
                 max_question_tokens: int = 23,
                 special_tokens: Optional[Mapping[str, int]] = None,
                 reduced_decode: int = 0, num_workers: int = 0):
        self.tokenizer = tokenizer or HashTokenizer(vocab_size=163840)
        self.image_size = tuple(image_size)
        step = patch_size * merge
        self.padded_size = tuple(-(-n // step) * step
                                 for n in self.image_size)
        self.image_tokens = (self.padded_size[0] // step) * \
            (self.padded_size[1] // step)
        self.max_question_tokens = max_question_tokens
        self.reduced_decode = reduced_decode
        self.num_workers = num_workers
        sp = {**self.SPECIAL_TOKENS, **(special_tokens or {})}
        self.eos, self.pad = sp["im_end"], sp["pad"]
        words = lambda text: self._words([text], 8)[0]
        self.prefix = [sp["im_user"], *words("user"), sp["im_middle"],
                       sp["media_start"], *words("image"), sp["media_content"],
                       *[sp["media_pad"]] * self.image_tokens,
                       sp["media_end"]]
        self.suffix = [sp["im_end"], sp["im_assistant"], *words("assistant"),
                       sp["im_middle"]]
        self.length = len(self.prefix) + max_question_tokens \
            + len(self.suffix)

    def _words(self, texts: Sequence[str], limit: int) -> List[List[int]]:
        """Each text's ids, without the tokenizer's end token."""
        ids, mask = self.tokenizer(list(texts), limit + 1)
        eos = getattr(self.tokenizer, "eos_token_id", None)
        out = []
        for row, n in zip(ids, mask.sum(axis=1)):
            row = [int(t) for t in row[:n]]
            out.append(row[:-1] if row and row[-1] == eos else row[:limit])
        return out

    def load_images(self, paths: Sequence[str]) -> np.ndarray:
        """uint8 [B, H, W, 3] at ``image_size``."""
        h, w = self.image_size
        return load_image_batch(
            list(paths), (w, h), emit_uint8=True, reduce=self.reduced_decode,
            workers=self.num_workers)

    def __call__(self, requests: Sequence[Tuple[str, str]], batch: int
                 ) -> Dict[str, np.ndarray]:
        n = len(requests)
        fill = list(range(n)) + [0] * (batch - n)
        with span("collate.images"):
            images = self.load_images([requests[i][0] for i in range(n)])
            h, w = self.image_size
            pixels = np.zeros((batch, *self.padded_size, 3), np.uint8)
            pixels[:, :h, :w] = images[fill]
        with span("collate.text"):
            questions = self._words([q for _, q in requests],
                                    self.max_question_tokens)
            input_ids = np.full((batch, self.length), self.pad, np.int64)
            lengths = np.empty(batch, np.int64)
            for row, i in enumerate(fill):
                prompt = self.prefix + questions[i] + self.suffix
                input_ids[row, :len(prompt)] = prompt
                lengths[row] = len(prompt)
        return {"input_ids": input_ids, "lengths": lengths,
                "pixel_values": pixels}
