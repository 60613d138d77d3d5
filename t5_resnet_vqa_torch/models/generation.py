"""Greedy and beam answer generation for the ViT + T5 encoder-decoder model,
and greedy generation through a KV cache for Kimi-VL.

PyTorch counterpart of ``t5_resnet_vqa_tpu/models/generation.py``: the
"[Question] {q} [Answer]" prompt is continued over the T5 vocabulary through
the tied LM head. The decode buffer is the prompt's length plus
``max_answer_length``; each of the ``max_answer_length`` steps (a Python
loop) is one full-sequence decoder pass, with no KV cache, as in the JAX
package. Rows have their own prompt lengths: step t reads the logits at
``prompt_len + t - 1`` and writes at ``prompt_len + t``. Only the read
position goes through the LM head: each position's logits are independent
of the others, so this is the JAX package's [B, L, vocab] product without
the rows it discards.

``cached_greedy_generate`` (the ``kimi_vl`` family, ``models/kimi_vl.py``)
runs the prompt once (prefill: the image tokens, the whole prompt, the
latent cache written) and then one token a step: each decode step reads
the cache and writes its own entry at the row's next position, so no step
runs the prompt again. Rows keep their own prompt lengths. It returns the
greedy tokens with the fp32 log-probabilities of the top tokens at every
step. Its counters: ``generate.prefills``, ``generate.steps``.

Call under ``torch.inference_mode()`` (the session does).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..core import constants
from ..utils.profiling import count


def _extend(ids: torch.Tensor, mask: torch.Tensor, extra: int):
    pad = torch.nn.functional.pad
    return pad(ids, (0, extra)), pad(mask, (0, extra))


def _step_logits(model, ids, mask, fused, pos) -> torch.Tensor:
    """fp32 vocab logits [rows, V] at position ``pos[r]`` of each row."""
    hidden = model.decode_hidden(ids, mask, fused)
    rows = torch.arange(hidden.shape[0], device=hidden.device)
    return model.vocab_logits(hidden[rows, pos])


def greedy_generate(model, question_input_ids, question_attention_masks,
                    decoder_question_input_ids,
                    decoder_question_attention_masks, pixel_values,
                    max_answer_length: int = 5) -> torch.Tensor:
    """-> [B, max_answer_length] generated token ids (0 after EOS)."""
    fused = model.fuse(question_input_ids, question_attention_masks,
                       pixel_values)
    ids, mask = _extend(decoder_question_input_ids,
                        decoder_question_attention_masks, max_answer_length)
    B = ids.shape[0]
    rows = torch.arange(B, device=ids.device)
    prompt_len = decoder_question_attention_masks.sum(dim=1)
    done = torch.zeros(B, dtype=torch.bool, device=ids.device)
    for t in range(max_answer_length):
        pos = prompt_len + t - 1                               # last live
        nxt = _step_logits(model, ids, mask, fused, pos).argmax(dim=-1)
        nxt = torch.where(done, 0, nxt).to(ids.dtype)
        ids[rows, pos + 1] = nxt
        mask[rows, pos + 1] = (~done).to(mask.dtype)
        done = done | (nxt == constants.EOS_TOKEN_ID)
    take = prompt_len[:, None] + torch.arange(max_answer_length,
                                              device=ids.device)
    return ids.gather(1, take)


def beam_generate(model, question_input_ids, question_attention_masks,
                  decoder_question_input_ids,
                  decoder_question_attention_masks, pixel_values,
                  max_answer_length: int = 5,
                  num_beams: int = constants.NUM_BEAMS
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Beam search -> (tokens [B, max_answer_length], scores [B]).

    Beams ride an expanded batch [B*K]. Only beam 0 is live at first (beams
    1..K-1 start at -1e9); a finished beam (EOS) continues only with pad at
    score 0, so it freezes; the best beam is the one with the highest sum
    of log-probs over its generated length (EOS included)."""
    fused = model.fuse(question_input_ids, question_attention_masks,
                       pixel_values)
    B = fused.shape[0]
    K = num_beams
    dev = fused.device
    ids, mask = _extend(decoder_question_input_ids,
                        decoder_question_attention_masks, max_answer_length)
    L = ids.shape[1]
    prompt_len = decoder_question_attention_masks.sum(dim=1)

    ids_k = ids.repeat_interleave(K, dim=0)
    mask_k = mask.repeat_interleave(K, dim=0)
    fused_k = fused.repeat_interleave(K, dim=0)
    plen_k = prompt_len.repeat_interleave(K, dim=0)
    rows_k = torch.arange(B * K, device=dev)
    scores = torch.full((B, K), -1e9, dtype=torch.float32, device=dev)
    scores[:, 0] = 0.0
    done = torch.zeros((B, K), dtype=torch.bool, device=dev)

    for t in range(max_answer_length):
        logits = _step_logits(model, ids_k, mask_k, fused_k, plen_k + t - 1)
        V = logits.shape[-1]
        logp = torch.log_softmax(logits, dim=-1).reshape(B, K, V)
        # a finished beam contributes exactly one continuation: pad, score 0
        pad_row = torch.full((V,), -1e9, dtype=torch.float32, device=dev)
        pad_row[0] = 0.0
        logp = torch.where(done[:, :, None], pad_row, logp)

        total = scores[:, :, None] + logp                      # [B, K, V]
        scores, flat_idx = total.reshape(B, K * V).topk(K, dim=-1)
        parent = flat_idx // V
        token = (flat_idx % V).to(ids_k.dtype)

        gather = (torch.arange(B, device=dev)[:, None] * K + parent).reshape(-1)
        ids_k, mask_k = ids_k[gather], mask_k[gather]
        done_p = done.reshape(-1)[gather].reshape(B, K)

        write = plen_k + t
        tok = torch.where(done_p, 0, token)
        ids_k[rows_k, write] = tok.reshape(-1)
        mask_k[rows_k, write] = (~done_p).reshape(-1).to(mask_k.dtype)
        done = done_p | (tok == constants.EOS_TOKEN_ID)

    gen_len = (mask_k.reshape(B, K, L).sum(-1)
               - prompt_len[:, None]).clamp(min=1)
    norm = scores / gen_len.to(scores.dtype)
    best = norm.argmax(dim=-1)                                 # [B]
    ids_best = ids_k[torch.arange(B, device=dev) * K + best]
    take = prompt_len[:, None] + torch.arange(max_answer_length, device=dev)
    return ids_best.gather(1, take), norm.gather(1, best[:, None])[:, 0]


def cached_greedy_generate(model, input_ids: torch.Tensor,
                           lengths: torch.Tensor, pixel_values: torch.Tensor,
                           max_answer_length: int = 5, top_k: int = 5
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """Greedy answers of a ``KimiVLModel``: prompts ``input_ids`` [B, S]
    padded on the right to S, row b's of length ``lengths[b]``, and their
    images. -> (tokens [B, T], the top ``top_k`` ids [B, T, k] and their
    fp32 log-probs [B, T, k] at each of the T = ``max_answer_length``
    steps); the token of a step is its top id. Every row runs all T steps
    (the caller cuts an answer at its end token)."""
    B, S = input_ids.shape
    images = model.encode_images(pixel_values)
    cache = model.new_cache(B, S + max_answer_length - 1)
    count("generate.prefills")
    logits = model.prefill(input_ids, lengths, images, cache)
    positions = lengths - 1
    ids, values = [], []
    for t in range(max_answer_length):
        if t:
            count("generate.steps")
            positions = positions + 1
            logits = model.decode_step(ids[-1][:, 0], positions, cache, S + t)
        top = logits.log_softmax(dim=-1).topk(top_k, dim=-1)
        ids.append(top.indices)
        values.append(top.values)
    ids, values = torch.stack(ids, dim=1), torch.stack(values, dim=1)
    return ids[..., 0], ids, values
