"""The port's copies of the text metrics and the tokenizer
(``syncvsr_tpu_torch/utils/text.py``, ``data/tokenizer.py`` and its asset
files) against the JAX package's originals: exact equality."""

import hashlib
import os

import numpy as np
import pytest

from syncvsr_tpu.data import tokenizer as jtok
from syncvsr_tpu.utils import text as jtext
from syncvsr_tpu_torch.data import tokenizer as ttok
from syncvsr_tpu_torch.utils import text as ttext
import torch_threads  # noqa: F401  (one torch thread a test process)

SENTENCES = [
    "HELLO WORLD",
    "THE QUICK BROWN FOX JUMPS OVER THE LAZY DOG",
    "  LEADING AND   TRAILING SPACES  ",
    "I DON'T KNOW WHAT YOU'RE TALKING ABOUT",
    "ZZXQJ QWXZ UNKNOWN PIECES",
    "NUMBERS 1999 AND 2024",
    "",
    "A",
]


@pytest.fixture(scope="module")
def transforms():
    return jtok.TextTransform(), ttok.TextTransform()


@pytest.mark.parametrize("name", ["unigram5000.model", "unigram5000_units.txt"])
def test_asset_bytes_equal(name):
    """The port's asset files are byte copies, and the port reads its own."""
    def digest(path):
        with open(path, "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()

    assert digest(os.path.join(ttok.ASSET_DIR, name)) == digest(os.path.join(jtok.ASSET_DIR, name))
    assert os.path.realpath(ttok.ASSET_DIR) != os.path.realpath(jtok.ASSET_DIR)
    assert "syncvsr_tpu_torch" in os.path.realpath(ttok.SP_MODEL_PATH).split(os.sep)


def test_tokenizer_equal_on_sentences(transforms):
    jt, tt = transforms
    assert tt.vocab_size == jt.vocab_size == 5049
    assert tt.token_list == jt.token_list
    for s in SENTENCES:
        assert tt.spm.encode_as_pieces(s) == jt.spm.encode_as_pieces(s), s
        ids = tt.tokenize(s)
        np.testing.assert_array_equal(ids, jt.tokenize(s))
        assert tt.post_process(ids) == jt.post_process(ids)


def test_post_process_equal_on_random_tokens(transforms):
    jt, tt = transforms
    rng = np.random.RandomState(0)
    for _ in range(50):
        ids = rng.randint(-1, jt.vocab_size, rng.randint(0, 30))
        assert tt.post_process(ids) == jt.post_process(ids)


def test_build_text_transform_equal(tmp_path, transforms):
    jt, _ = transforms
    assert ttok.build_text_transform("").token_list == jt.token_list
    model = tmp_path / "custom.model"
    model.write_bytes(open(ttok.SP_MODEL_PATH, "rb").read())
    with pytest.raises(FileNotFoundError, match="units table"):
        ttok.build_text_transform(str(model))
    with pytest.raises(FileNotFoundError, match="not found"):
        ttok.build_text_transform(str(tmp_path / "missing.model"))
    (tmp_path / "custom_units.txt").write_bytes(open(ttok.DICT_PATH, "rb").read())
    a = ttok.build_text_transform(str(model))
    b = jtok.build_text_transform(str(model))
    assert a.token_list == b.token_list
    np.testing.assert_array_equal(a.tokenize(SENTENCES[1]), b.tokenize(SENTENCES[1]))


def test_text_metrics_equal():
    rng = np.random.RandomState(1)
    words = ["A", "B", "C", "HELLO", "WORLD"]
    jw, tw = jtext.WordErrorRate(), ttext.WordErrorRate()
    je, te = jtext.ErrorCalculator(), ttext.ErrorCalculator()
    for _ in range(40):
        ref = " ".join(rng.choice(words, rng.randint(0, 8)))
        hyp = " ".join(rng.choice(words, rng.randint(0, 8)))
        assert ttext.edit_distance(ref.split(), hyp.split()) == \
            jtext.edit_distance(ref.split(), hyp.split())
        assert ttext.edit_distance(ref, hyp) == jtext.edit_distance(ref, hyp)
        for j, t in ((jw, tw), (je, te)):
            j.update(ref, hyp)
            t.update(ref, hyp)
    assert tw.wer == jw.wer and tw.total_edit_distance == jw.total_edit_distance
    assert (te.wer, te.cer, te.char_edits, te.word_total) == \
        (je.wer, je.cer, je.char_edits, je.word_total)
