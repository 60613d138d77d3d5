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
``generate_batch`` (the ViT and Kimi-VL families) into token ids and text.

The ``kimi_vl`` family (``models/kimi_vl.py``) only generates: its collate
(``KimiVLCollate``) builds chat prompts around 414 image placeholders and
pads the uint8 images; ``generate_batch`` prefills each chunk's prompts
once and decodes through the latent cache
(``generation.cached_greedy_generate``), and its records add
``"token_logprobs"``. Its model computes in the dtype of its weights (no
autocast), and a ``state_dict`` is taken as it is (``assign=True``) into a
model built on ``meta``, so the session holds one copy of the weights.

``from_checkpoint`` serves what a trainer wrote: ``best-model.pt`` and the
answer space of ``model_ckpt_info.json`` under the config's output
directory, with the config's image path and tokenizer. It computes as the
trainer's eval step does (fp32 weights under autocast to the compute dtype,
a frozen tower held in that dtype), so served answers equal validation's.

Both launch every chunk's work before they read any result back, so chunk
k+1's host preprocessing overlaps chunk k's device work (CUDA launches are
asynchronous; the copies to the host at the end are the only
synchronisations).

With a ``mesh`` (``parallel/``) the session runs SPMD on every rank: the
model is split over the model axis, every rank collates the same chunk,
runs its rows of it (the fixed batch must divide over the data axis) and
gathers the log-probs or the generated tokens over the data axis, so every
rank decodes the same answers. For a server, rank 0 wraps its session in
``MeshLeader``, which hands each call to the other ranks, and they run
``follow`` until the leader's ``close()``.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.device import DeviceLike, resolve_device
from ..data.collate import DaquarCnnCollate, DaquarVitCollate, KimiVLCollate
from ..data.daquar import Annotation, Question, Sample
from ..models import generation
from ..parallel import sharding as shd
from ..utils.profiling import count, span
from .predict import convert_logits_to_predictions_topk

CNN_FAMILY = "cnn"
VIT_FAMILY = "vit"
CROSS_FAMILY = "cross_attention"
KIMI_FAMILY = "kimi_vl"

# collate keys the forward does not take (the eval records, the dummy label)
_HOST_KEYS = ("answers", "questions", "image_fns", "annotation_ids")


class VQAInferenceSession:
    """Ask (image path, question) pairs against a model of any family.

    ``state_dict``, when given, is loaded into ``model`` with
    ``strict=True``. The model is moved to ``device`` (default ``"cuda"``,
    which raises without a card; the CPU only when named) and put in
    ``eval()`` mode. With a ``compute_dtype`` other than fp32 the forward
    runs under autocast to it and a frozen tower is held in it, as in the
    trainer. With a ``mesh`` the model (full weights) is split over it and
    placed on the mesh's device, and ``batch_size`` must divide over its
    data axis.
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
                 device: DeviceLike = None,
                 mesh: Optional[shd.Mesh] = None):
        if family not in (CNN_FAMILY, VIT_FAMILY, CROSS_FAMILY, KIMI_FAMILY):
            raise NotImplementedError(
                f"the port serves the {CNN_FAMILY!r}, {VIT_FAMILY!r}, "
                f"{CROSS_FAMILY!r} and {KIMI_FAMILY!r} families, not "
                f"{family!r}")
        if family == KIMI_FAMILY and (mesh is not None or not uint8_wire):
            raise NotImplementedError(
                f"the {KIMI_FAMILY!r} family is served on one device with "
                f"uint8 images")
        if mesh is not None and batch_size % mesh.data:
            raise ValueError(
                f"serving batch_size {batch_size} must divide evenly over "
                f"the mesh data axis ({mesh.data} ways)")
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else \
            resolve_device(device)
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
        elif family == KIMI_FAMILY:
            config = model.config
            self.collate = KimiVLCollate(
                tokenizer, image_size if isinstance(image_size, tuple)
                else (image_size, image_size), config.vision.patch_size,
                config.vision.merge, config.max_question_tokens,
                {**dict(config.special_tokens),
                 "media_pad": config.media_placeholder_token_id},
                reduced_decode=reduced_decode, num_workers=num_workers)
        else:
            self.collate = DaquarVitCollate(self.answer_spaces, **kw)
        if state_dict is not None and family == KIMI_FAMILY:
            model.load_state_dict(state_dict, strict=True, assign=True)
        elif state_dict is not None:
            model.load_state_dict(state_dict, strict=True)
        from ..train.trainer import prepare_model
        self.model = prepare_model(model, self.device, compute_dtype).eval()
        if mesh is not None:
            from ..parallel.tensor_parallel import shard_model_
            shard_model_(self.model, mesh)

    @classmethod
    def from_checkpoint(cls, config, batch_size: int = 8, tokenizer=None,
                        device: DeviceLike = None,
                        mesh: Optional[shd.Mesh] = None
                        ) -> "VQAInferenceSession":
        """Serve ``best-model.pt`` and the answer space of
        ``model_ckpt_info.json`` from ``config.trainer.output_dir``, with
        the config's model, image path (``reduced_decode`` and
        ``num_workers`` included), tokenizer and compute dtype.
        ``device=None`` is the config's ``trainer.device`` (the card unless
        it says "cpu"); with a ``mesh``, the mesh's device, every rank
        loading the full checkpoint and keeping its share."""
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
        if mesh is not None:
            device = mesh.device
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
            compute_dtype=config_compute_dtype(config), device=device,
            mesh=mesh)
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
            with span("session.readback"):
                log_probs = self._gather(log_probs)[:n].cpu().numpy()
            out.extend(self._decode(log_probs, top_k))
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
        The ``kimi_vl`` family generates greedily through its cache
        (``_generate_cached``). The hash tokenizer cannot invert word ids,
        so its ``answer_text`` holds ``<id>`` placeholders (a warning says
        so)."""
        if self.family == KIMI_FAMILY:
            if num_beams != 1:
                raise ValueError(f"the {KIMI_FAMILY!r} family generates "
                                 f"greedily (num_beams=1)")
            return self._generate_cached(requests, max_answer_length)
        if self.family != VIT_FAMILY:
            # JAX's words: the HTTP server sends them as a 400's body
            raise ValueError(
                f"generate_batch needs the ViT enc-dec family (T5 decoder); "
                f"this session serves a {self.family!r} model — use "
                f"ask/ask_batch for classification answers")
        tokenizer = self.collate.tokenizer
        self._warn_hash_tokenizer()
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
            with span("session.readback"):
                tokens = self._gather(tokens)[:n].cpu().numpy()
                if scores is not None:
                    scores = self._gather(scores)[:n].cpu().numpy()
            for i in range(n):
                ids = [int(t) for t in tokens[i] if int(t) != 0]
                rec = {"answer_text": tokenizer.decode(ids), "token_ids": ids}
                if scores is not None:
                    rec["score"] = float(scores[i])
                out.append(rec)
        return out

    def _generate_cached(self, requests: Sequence[Tuple[str, str]],
                         max_answer_length: int) -> List[dict]:
        """The ``kimi_vl`` family: per request ``{"answer_text",
        "token_ids", "token_logprobs"}``, the tokens up to and with the end
        token, and at each of their steps the top-5 ``"ids"`` and their fp32
        log-prob ``"values"``."""
        self._warn_hash_tokenizer()
        pending = []   # (device tokens, top ids, top log-probs, n_valid)
        for start in range(0, len(requests), self.batch_size):
            chunk = requests[start:start + self.batch_size]
            batch = self._to_device(self._collate_prompts(chunk))
            with torch.inference_mode():
                out = generation.cached_greedy_generate(
                    self.model, batch["input_ids"], batch["lengths"],
                    batch["pixel_values"], max_answer_length)
            pending.append((out, len(chunk)))
        records: List[dict] = []
        eos = self.collate.eos
        for out, n in pending:
            with span("session.readback"):
                tokens, ids, values = (t[:n].cpu().numpy() for t in out)
            for i in range(n):
                row = [int(t) for t in tokens[i]]
                end = row.index(eos) + 1 if eos in row else len(row)
                records.append({
                    "answer_text": self.collate.tokenizer.decode(
                        [t for t in row[:end] if t != eos]),
                    "token_ids": row[:end],
                    "token_logprobs": {"ids": ids[i, :end].tolist(),
                                       "values": values[i, :end].tolist()}})
        return records

    # ------------------------------------------------------------- internals

    def _warn_hash_tokenizer(self) -> None:
        if str(getattr(self.collate.tokenizer, "scheme", "")
               ).startswith("hash"):
            import warnings
            warnings.warn(
                "generate_batch: the session's tokenizer is the offline hash "
                "fallback: generated ids are NOT invertible to text and "
                "answer_text holds '<id>' placeholders", stacklevel=3)

    @span("session.collate")
    def _collate_prompts(self, chunk: Sequence[Tuple[str, str]]
                         ) -> Dict[str, np.ndarray]:
        """The ``kimi_vl`` family's chunk: prompts and padded images at the
        fixed batch."""
        count("session.chunks")
        return self.collate(chunk, self.batch_size)

    @span("session.collate")
    def _collate_chunk(self, chunk: Sequence[Tuple[str, str]]
                       ) -> Dict[str, np.ndarray]:
        """Collate and pad a request chunk to the fixed batch shape."""
        count("session.chunks")
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
        if self.mesh is not None:       # this rank's rows
            rows = self.mesh.batch_rows(self.batch_size)
            batch = {k: v[rows] for k, v in batch.items()}
        return batch

    def _gather(self, t: torch.Tensor) -> torch.Tensor:
        """A chunk's per-row results on every rank (a mesh's data axis)."""
        return t if self.mesh is None else shd.gather_rows(t, self.mesh)

    @span("session.copy")
    def _to_device(self, batch: Mapping[str, np.ndarray]
                   ) -> Dict[str, torch.Tensor]:
        """The chunk's arrays as tensors on the device. They come from
        pageable host memory: a copy to a CUDA device is counted in
        ``session.pageable_bytes``."""
        host = {k: np.ascontiguousarray(v) for k, v in batch.items()}
        if self.device.type == "cuda":
            count("session.pageable_bytes",
                  sum(v.nbytes for v in host.values()))
        return {k: torch.from_numpy(v).to(self.device, non_blocking=True)
                for k, v in host.items()}

    def _autocast(self):
        from ..train.trainer import _autocast
        return _autocast(self.device, self.compute_dtype)

    @span("session.forward")
    def _predict(self, batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """One forward on a device batch; returns fp32 log-probs [B, A]."""
        with torch.inference_mode(), self._autocast():
            log_probs, _ = self.model(**batch)
        return log_probs

    def _dispatch_chunk(self, chunk: Sequence[Tuple[str, str]]
                        ) -> torch.Tensor:
        """Collate, pad, copy to the device and launch; no host sync."""
        return self._predict(self._to_device(self._collate_chunk(chunk)))

    @span("session.decode")
    def _decode(self, log_probs: np.ndarray, top_k: int) -> List[dict]:
        order = convert_logits_to_predictions_topk(log_probs, top_k)
        probs = np.exp(np.take_along_axis(log_probs, order, axis=-1))
        return [{
            "answer": self.answer_spaces[int(order[i, 0])],
            "top_answers": [self.answer_spaces[int(j)] for j in order[i]],
            "top_probs": [float(p) for p in probs[i]],
        } for i in range(len(log_probs))]


class MeshLeader:
    """Rank 0's session behind a server: each ``ask``/``ask_batch``/
    ``generate``/``generate_batch`` is handed to the other ranks (running
    ``follow``) before rank 0 runs it; ``close()`` lets them go. Other
    attributes are the session's."""

    def __init__(self, session: VQAInferenceSession):
        self.session = session

    def __getattr__(self, name):
        return getattr(self.session, name)

    def _lead(self, method: str, *args, **kwargs):
        shd.broadcast_object((method, args, kwargs), self.session.mesh)
        return getattr(self.session, method)(*args, **kwargs)

    def ask_batch(self, requests, top_k: int = 1) -> List[dict]:
        return self._lead("ask_batch", list(requests), top_k=top_k)

    def ask(self, image: str, question: str, top_k: int = 1) -> dict:
        return self.ask_batch([(image, question)], top_k=top_k)[0]

    def generate_batch(self, requests, num_beams: int = 1,
                       max_answer_length: int = 5) -> List[dict]:
        return self._lead("generate_batch", list(requests),
                          num_beams=num_beams,
                          max_answer_length=max_answer_length)

    def generate(self, image: str, question: str, num_beams: int = 1,
                 max_answer_length: int = 5) -> dict:
        return self.generate_batch([(image, question)], num_beams=num_beams,
                                   max_answer_length=max_answer_length)[0]

    def close(self) -> None:
        shd.broadcast_object(None, self.session.mesh)


def follow(session: VQAInferenceSession) -> int:
    """A rank other than 0: run the leader's calls until its ``close()``.
    A call the leader's session refuses (a ``ValueError`` raised before
    any collective, as ``generate_batch`` on a classifier) is refused here
    too, and the loop goes on. Returns the number of calls run."""
    calls = 0
    while True:
        command = shd.broadcast_object(None, session.mesh)
        if command is None:
            return calls
        method, args, kwargs = command
        try:
            getattr(session, method)(*args, **kwargs)
        except ValueError:
            pass
        calls += 1
