"""``build_answer_space`` and ``write_answer_space`` of the port against the
JAX package's (which reads the CSV with pandas; the port with ``csv``).

Two train CSVs: the synthetic DAQUAR one, and a hand-written one whose
answers have spaces ("dark blue" -> "dark_blue"), commas (multi-word
answers, dropped by the single-word filter), quotes and the 'O' class.
Every combination of ``min_count``, ``single_word_only`` and
``include_oov_class`` gives JAX's list, and the written file is JAX's byte
for byte. The port's build runs in a fresh interpreter where pandas cannot
import.
"""

import os
import subprocess
import sys

import pytest

from t5_resnet_vqa_tpu.data import make_synthetic_daquar
from t5_resnet_vqa_tpu.data.answer_space import (
    build_answer_space as jax_build,
)
from t5_resnet_vqa_tpu.data.answer_space import (
    write_answer_space as jax_write,
)
from t5_resnet_vqa_torch.data import build_answer_space, write_answer_space

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CUSTOM_ROWS = [
    ("image1", "what is on the table", ["red", "dark blue", "O"]),
    ("image2", "what is it", ["chair, table", "red", "red"]),
    ("image3", "what colour", ["dark blue", "O", "chair, table"]),
    ("image1", "what is 'that'", ["lamp", "red", "dark blue"]),
    ("image2", "how many", ["2", "chair, table", "lamp"]),
]


@pytest.fixture(scope="module")
def csvs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("answer_space")
    root, kw = make_synthetic_daquar(str(tmp / "daquar"), num_train=40,
                                     num_test=2, image_size=8)
    custom = str(tmp / "custom.csv")
    with open(custom, "w") as f:
        f.write("image_id,question,answers_list\n")
        for image_id, q, answers in CUSTOM_ROWS:
            f.write(f'{image_id},"{q}","{answers!r}"\n')
    return {"synthetic": os.path.join(root, kw["train_csv_file"]),
            "custom": custom}


@pytest.mark.parametrize("include_oov", [True, False])
@pytest.mark.parametrize("single_word", [True, False])
@pytest.mark.parametrize("min_count", [1, 2])
@pytest.mark.parametrize("which", ["synthetic", "custom"])
def test_answer_space_matches_jax(csvs, which, min_count, single_word,
                                  include_oov):
    kw = dict(min_count=min_count, single_word_only=single_word,
              include_oov_class=include_oov)
    got = build_answer_space(csvs[which], **kw)
    assert got == jax_build(csvs[which], **kw)
    assert ("O" in got) == include_oov
    if which == "custom":
        assert "dark_blue" in got
        assert ("chair,_table" in got) == (not single_word)


def test_written_file_matches_jax(csvs, tmp_path):
    answers = build_answer_space(csvs["synthetic"], min_count=1)
    write_answer_space(answers, str(tmp_path / "port.txt"))
    jax_write(answers, str(tmp_path / "jax.txt"))
    assert (tmp_path / "port.txt").read_bytes() == \
        (tmp_path / "jax.txt").read_bytes()


def test_builds_without_pandas(csvs):
    code = ("import sys\n"
            "sys.modules['pandas'] = None\n"
            "from t5_resnet_vqa_torch.data import build_answer_space\n"
            f"print(build_answer_space({csvs['custom']!r}, min_count=2))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == repr(jax_build(csvs["custom"], min_count=2))
