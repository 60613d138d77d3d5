"""Faults planted under a run, to show that its comparison catches them.
Only the tests and ``calibrate.py`` plant them; a benchmark run never
does.

* ``unchanged_step``: the optimizer's step returns the state unchanged;
* ``half_batch``: the model sees the first half of each batch's rows, so
  the loss is the mean over them;
* ``altered_answer``: each served answer (the answer and its top-k) is
  replaced by the next one of the answer space where the session
  produces it.
"""

from __future__ import annotations

FAULTS = ("unchanged_step", "half_batch", "altered_answer")


def _half(x):
    import torch

    return x[:x.shape[0] // 2] if isinstance(x, torch.Tensor) and x.dim() \
        else x


def apply(fault, model=None, optimizer=None, session=None) -> None:
    if fault is None:
        return
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}; known: {FAULTS}")
    if fault == "unchanged_step" and optimizer is not None:
        optimizer.step = lambda *args, **kwargs: None
    elif fault == "half_batch" and model is not None:
        forward = model.forward
        model.forward = lambda *args, **kwargs: forward(
            *(_half(a) for a in args),
            **{k: _half(v) for k, v in kwargs.items()})
    elif fault == "altered_answer" and session is not None:
        decode = session._decode
        answers = session.answer_spaces

        def shifted(answer):
            return answers[(answers.index(answer) + 1) % len(answers)]

        def altered(log_probs, top_k):
            out = decode(log_probs, top_k)
            for rec in out:
                rec["answer"] = shifted(rec["answer"])
                rec["top_answers"] = [shifted(a) for a in rec["top_answers"]]
            return out

        session._decode = altered
