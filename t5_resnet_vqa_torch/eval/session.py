"""Batched VQA inference session for the four families (the serving
surface).

PyTorch counterpart of ``VQAInferenceSession`` in the JAX package's
``eval/session.py``: requests are collated exactly as in training (the CNN
family, ResNet or Faster-RCNN tower: unnormalized 256^2 images with the
configured interpolation; the ViT and the cross-attention families: 224^2
pixel values with mean = std = 0.5; uint8 on the wire, or float from the
host, bilinear through the native resize, with ``uint8_wire=False``),
padded up to a fixed batch, run under ``torch.inference_mode`` with the
model in ``eval()``, and decoded: ``ask_batch`` against the answer space,
``generate_batch`` (ViT family only) into token ids and text.

``from_checkpoint`` serves what a trainer wrote: ``best-model.pt`` and the
answer space of ``model_ckpt_info.json`` under the config's output
directory, with the config's image path and tokenizer. It computes as the
trainer's eval step does (fp32 weights under autocast to the compute dtype,
a frozen tower held in that dtype), so served answers equal validation's.

Both launch every chunk's work before they read any result back, so chunk
k+1's host preprocessing overlaps chunk k's device work (CUDA launches are
asynchronous; the copies to the host at the end are the only
synchronisations).
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.device import DeviceLike, resolve_device
from ..data.collate import DaquarCnnCollate, DaquarVitCollate
from ..data.daquar import Annotation, Question, Sample
from ..models import generation
from .predict import convert_logits_to_predictions_topk

CNN_FAMILY = "cnn"
VIT_FAMILY = "vit"
CROSS_FAMILY = "cross_attention"

# collate keys the forward does not take (the eval records, the dummy label)
_HOST_KEYS = ("answers", "questions", "image_fns", "annotation_ids")


class VQAInferenceSession:
    """Ask (image path, question) pairs against a model of any family.

    ``state_dict``, when given, is loaded into ``model`` with
    ``strict=True``. The model is moved to ``device`` (default ``"cuda"``,
    which raises without a card; the CPU only when named) and put in
    ``eval()`` mode. With a ``compute_dtype`` other than fp32 the forward
    runs under autocast to it and a frozen tower is held in it, as in the
    trainer.
    """

    def __init__(self, model: torch.nn.Module,
                 state_dict: Optional[Mapping[str, torch.Tensor]],
                 answer_spaces: Sequence[str], family: str = CNN_FAMILY,
                 batch_size: int = 8, image_size: int = 256,
                 interpolation_strategy: str = "bilinear_interpolation",
                 lang_model: str = "t5-base", tokenizer=None,
                 uint8_wire: bool = True, reduced_decode: int = 0,
                 num_workers: int = 0,
                 compute_dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None):
        if family not in (CNN_FAMILY, VIT_FAMILY, CROSS_FAMILY):
            raise NotImplementedError(
                f"the port serves the {CNN_FAMILY!r}, {VIT_FAMILY!r} and "
                f"{CROSS_FAMILY!r} families, not {family!r}")
        self.device = resolve_device(device)
        self.family = family
        self.answer_spaces = list(answer_spaces)
        self.batch_size = int(batch_size)
        self.compute_dtype = compute_dtype
        # with uint8 on the wire the model scales (and, for the ViT family,
        # normalizes) the images on the device
        kw = dict(lang_model=lang_model, eval_mode=True, tokenizer=tokenizer,
                  emit_uint8=uint8_wire, reduced_decode=reduced_decode,
                  num_workers=num_workers)
        if family == CNN_FAMILY:
            self.collate = DaquarCnnCollate(
                self.answer_spaces, interpolation_strategy,
                resizing_dimensions=(image_size, image_size), **kw)
        else:
            self.collate = DaquarVitCollate(self.answer_spaces, **kw)
        if state_dict is not None:
            model.load_state_dict(state_dict, strict=True)
        from ..train.trainer import prepare_model
        self.model = prepare_model(model, self.device, compute_dtype).eval()

    @classmethod
    def from_checkpoint(cls, config, batch_size: int = 8, tokenizer=None,
                        device: DeviceLike = None) -> "VQAInferenceSession":
        """Serve ``best-model.pt`` and the answer space of
        ``model_ckpt_info.json`` from ``config.trainer.output_dir``, with
        the config's model, image path (``reduced_decode`` and
        ``num_workers`` included), tokenizer and compute dtype.
        ``device=None`` is the config's ``trainer.device`` (the card unless
        it says "cpu"). The JAX session's ``mesh`` has no counterpart yet
        (ROADMAP.md, modules item 11)."""
        from ..data import get_tokenizer
        from ..train import factory
        from ..train.callbacks import CheckpointManager
        from ..train.trainer import config_compute_dtype, trainer_device

        dk = config.dataset
        ckpt = CheckpointManager(config.trainer.output_dir)
        info = ckpt.read_json("model_ckpt_info.json")
        if info is None:
            raise FileNotFoundError(
                f"no model_ckpt_info.json under {ckpt.output_dir} (train "
                f"first; the answer space is part of the checkpoint "
                f"contract)")
        answer_spaces = info["answer_spaces"]
        device = (trainer_device(config.trainer.device) if device is None
                  else resolve_device(device))
        model, family = factory.build_model(config.model, len(answer_spaces),
                                            device=device)
        if tokenizer is None and dk.tokenizer_file:
            tokenizer = get_tokenizer(dk.language_model_tokenizer,
                                      tokenizer_file=dk.tokenizer_file)
        session = cls(
            model, ckpt.restore_tree("best-model"), answer_spaces, family,
            batch_size=batch_size, image_size=dk.image_size,
            interpolation_strategy=dk.interpolation_strategy,
            lang_model=dk.language_model_tokenizer, tokenizer=tokenizer,
            uint8_wire=dk.uint8_wire_images, reduced_decode=dk.reduced_decode,
            num_workers=dk.num_workers,
            compute_dtype=config_compute_dtype(config), device=device)
        # the trainer's resume guard: another id layout would scramble
        # every question's token ids
        saved = info.get("tokenizer_scheme")
        scheme = getattr(session.collate.tokenizer, "scheme", "unknown")
        if saved is not None and saved != scheme:
            raise ValueError(
                f"Tokenizer scheme mismatch: checkpoint was trained with "
                f"{saved!r} but this session tokenizes with {scheme!r}. "
                f"Point dataset_kwargs at the original tokenizer "
                f"(tokenizer_file / language_model_tokenizer).")
        return session

    # ------------------------------------------------------------------ api

    def ask(self, image: str, question: str, top_k: int = 1) -> dict:
        """Single-request convenience wrapper (pads to the fixed batch)."""
        return self.ask_batch([(image, question)], top_k=top_k)[0]

    def ask_batch(self, requests: Sequence[Tuple[str, str]],
                  top_k: int = 1) -> List[dict]:
        """Each request is (image_path, question_text). Returns per-request
        ``{"answer", "top_answers", "top_probs"}`` dicts, best first."""
        pending = []   # (device log_probs, n_valid) per chunk, not yet read
        for start in range(0, len(requests), self.batch_size):
            chunk = requests[start:start + self.batch_size]
            pending.append((self._dispatch_chunk(chunk), len(chunk)))
        out: List[dict] = []
        for log_probs, n in pending:
            out.extend(self._decode(log_probs[:n].cpu().numpy(), top_k))
        return out

    def generate(self, image: str, question: str, num_beams: int = 1,
                 max_answer_length: int = 5) -> dict:
        """Single-request generative answer (ViT family)."""
        return self.generate_batch([(image, question)], num_beams=num_beams,
                                   max_answer_length=max_answer_length)[0]

    def generate_batch(self, requests: Sequence[Tuple[str, str]],
                       num_beams: int = 1,
                       max_answer_length: int = 5) -> List[dict]:
        """Answers generated over the T5 vocabulary (ViT family): greedy for
        ``num_beams == 1``, beam search otherwise, continuing the collate's
        "[Question] {q} [Answer]" prompt. Returns per-request
        ``{"answer_text", "token_ids"}``, with ``"score"`` for beam search.
        The hash tokenizer cannot invert word ids, so its ``answer_text``
        holds ``<id>`` placeholders (a warning says so)."""
        if self.family != VIT_FAMILY:
            # JAX's words: the HTTP server sends them as a 400's body
            raise ValueError(
                f"generate_batch needs the ViT enc-dec family (T5 decoder); "
                f"this session serves a {self.family!r} model — use "
                f"ask/ask_batch for classification answers")
        tokenizer = self.collate.tokenizer
        if str(getattr(tokenizer, "scheme", "")).startswith("hash"):
            import warnings
            warnings.warn(
                "generate_batch: the session's tokenizer is the offline hash "
                "fallback: generated ids are NOT invertible to text and "
                "answer_text holds '<id>' placeholders", stacklevel=2)
        pending = []   # (device tokens, device scores or None, n_valid)
        for start in range(0, len(requests), self.batch_size):
            chunk = requests[start:start + self.batch_size]
            batch = self._to_device(self._collate_chunk(chunk))
            args = (batch["question_input_ids"],
                    batch["question_attention_masks"],
                    batch["decoder_question_input_ids"],
                    batch["decoder_question_attention_masks"],
                    batch["pixel_values"])
            with torch.inference_mode(), self._autocast():
                if num_beams > 1:
                    tokens, scores = generation.beam_generate(
                        self.model, *args,
                        max_answer_length=max_answer_length,
                        num_beams=num_beams)
                else:
                    tokens, scores = generation.greedy_generate(
                        self.model, *args,
                        max_answer_length=max_answer_length), None
            pending.append((tokens, scores, len(chunk)))
        out: List[dict] = []
        for tokens, scores, n in pending:
            tokens = tokens[:n].cpu().numpy()
            if scores is not None:
                scores = scores[:n].cpu().numpy()
            for i in range(n):
                ids = [int(t) for t in tokens[i] if int(t) != 0]
                rec = {"answer_text": tokenizer.decode(ids), "token_ids": ids}
                if scores is not None:
                    rec["score"] = float(scores[i])
                out.append(rec)
        return out

    # ------------------------------------------------------------- internals

    def _collate_chunk(self, chunk: Sequence[Tuple[str, str]]
                       ) -> Dict[str, np.ndarray]:
        """Collate and pad a request chunk to the fixed batch shape."""
        dummy = [self.answer_spaces[0]]
        samples = [
            Sample(Question(q, f"req_{i}", f"req_{i}"),
                   Annotation(f"req_{i}", f"req_{i}", list(dummy)), img)
            for i, (img, q) in enumerate(chunk)
        ]
        batch = self.collate(samples)
        batch = {k: v for k, v in batch.items() if k not in _HOST_KEYS}
        n = len(chunk)
        if n < self.batch_size:
            batch = {k: np.concatenate(
                [v, np.repeat(v[:1], self.batch_size - n, axis=0)])
                for k, v in batch.items()}
        return batch

    def _to_device(self, batch: Mapping[str, np.ndarray]
                   ) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(
            self.device, non_blocking=True) for k, v in batch.items()}

    def _autocast(self):
        from ..train.trainer import _autocast
        return _autocast(self.device, self.compute_dtype)

    def _predict(self, batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """One forward on a device batch; returns fp32 log-probs [B, A]."""
        with torch.inference_mode(), self._autocast():
            log_probs, _ = self.model(**batch)
        return log_probs

    def _dispatch_chunk(self, chunk: Sequence[Tuple[str, str]]
                        ) -> torch.Tensor:
        """Collate, pad, copy to the device and launch; no host sync."""
        return self._predict(self._to_device(self._collate_chunk(chunk)))

    def _decode(self, log_probs: np.ndarray, top_k: int) -> List[dict]:
        order = convert_logits_to_predictions_topk(log_probs, top_k)
        probs = np.exp(np.take_along_axis(log_probs, order, axis=-1))
        return [{
            "answer": self.answer_spaces[int(order[i, 0])],
            "top_answers": [self.answer_spaces[int(j)] for j in order[i]],
            "top_probs": [float(p) for p in probs[i]],
        } for i in range(len(log_probs))]
