"""The port's copy of the vendored DAQUAR vocabulary and the audits the
JAX package runs over its own (``tests/test_eval.py``,
``tests/test_data.py``), here over the port's ``mini_wordnet`` and
``HashTokenizer``:

* the copy holds the JAX module's words, in its order;
* every answer word has a taxonomy chain in the port's mini-WordNet (or is
  one of the words with no noun synset, which the reference scores 0);
* the port's hash tokenizer, with the answer words pinned, gives distinct
  ids in the reserved range to every word of the vocabulary (answers and
  question words), the JAX tokenizer's ids, and free text outside that
  range; raw hashing alone would collide over the same words.
"""

from t5_resnet_vqa_tpu.data import daquar_vocab as jax_vocab
from t5_resnet_vqa_tpu.data.tokenizer import HashTokenizer as JaxTokenizer
from t5_resnet_vqa_torch.data import daquar_vocab
from t5_resnet_vqa_torch.data.tokenizer import HashTokenizer
from t5_resnet_vqa_torch.eval import mini_wordnet as mw


def test_copy_holds_the_jax_words():
    assert daquar_vocab.ANSWER_WORDS == jax_vocab.ANSWER_WORDS
    assert daquar_vocab.QUESTION_WORDS == jax_vocab.QUESTION_WORDS
    assert daquar_vocab.vocabulary() == jax_vocab.vocabulary()
    assert len(set(daquar_vocab.ANSWER_WORDS)) > 300


def test_mini_wordnet_covers_every_answer_word():
    missing = [w for w in daquar_vocab.ANSWER_WORDS
               if not mw.synsets(w) and w not in mw.NO_NOUN_SYNSET]
    assert missing == [], f"answer words without chains: {missing}"


def test_hash_tokenizer_is_injective_and_equal_to_jax():
    ours = HashTokenizer(pinned_words=daquar_vocab.ANSWER_WORDS)
    theirs = JaxTokenizer(pinned_words=jax_vocab.ANSWER_WORDS)
    assert ours.pinned == theirs.pinned
    seen = {}
    for entry in daquar_vocab.ANSWER_WORDS:
        for w in ours._WORD_RE.findall(entry.lower()):
            wid = ours._word_id(w)
            assert seen.setdefault(wid, w) == w, (
                f"id collision: {w!r} vs {seen[wid]!r}")
            assert 100 <= wid < 1000          # the reserved pinned range
    for w in daquar_vocab.vocabulary():
        assert ours._word_id(w) == theirs._word_id(w), w
    for w in ["serendipity", "xylophone", "what", "behind"]:
        assert ours._word_id(w) >= 1000
    raw = HashTokenizer()
    raw_ids = [raw._word_id(w) for w in daquar_vocab.ANSWER_WORDS]
    assert len(set(raw_ids)) < len(set(daquar_vocab.ANSWER_WORDS))
    text = [" ".join(daquar_vocab.QUESTION_WORDS[:12])]
    ids, mask = ours(text, max_length=16)
    want_ids, want_mask = theirs(text, max_length=16)
    assert (ids == want_ids).all() and (mask == want_mask).all()
