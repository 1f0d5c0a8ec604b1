"""Text pipeline: tokenizer, dictionary, labeled sentences, PTB feeds (the
port's own copy of ``bigdl_tpu/dataset/text.py``, producing the port's
``Sample``s).

Reference: ``dataset/text/`` — ``SentenceTokenizer.scala`` (OpenNLP),
``Dictionary.scala``, ``TextToLabeledSentence.scala``,
``LabeledSentenceToSample.scala``, ``SentenceBiPadding.scala``,
``LabeledSentence.scala`` and the PTB feed of
``example/languagemodel/PTBWordLM.scala``. The tokenizer is the
reference's dependency-free regex splitter (no OpenNLP); everything
downstream is format-compatible.
"""

from __future__ import annotations

import re

import numpy as np

from bigdl_tpu_torch.dataset.sample import Sample
from bigdl_tpu_torch.dataset.transformer import Transformer

SENTENCE_START = "<s>"
SENTENCE_END = "</s>"
UNKNOWN = "<unk>"
PADDING = "<pad>"


def read_localfile(path):
    """All lines of a local text file (reference
    ``pyspark/bigdl/dataset/sentence.py`` ``read_localfile`` — the fetcher
    feeding the sentence split/tokenize/bipad chain below; newlines kept,
    as in the reference)."""
    with open(path) as f:
        return list(f)


class SentenceTokenizer(Transformer):
    """String sentence -> list of tokens
    (reference ``SentenceTokenizer.scala``)."""

    def __init__(self, lowercase=True):
        self.lowercase = lowercase
        self._pat = re.compile(r"[A-Za-z0-9']+|[.,!?;:\"()\-]")

    def tokenize(self, sentence):
        if self.lowercase:
            sentence = sentence.lower()
        return self._pat.findall(sentence)

    def apply(self, iterator):
        for sentence in iterator:
            yield self.tokenize(sentence)


class SentenceSplitter(Transformer):
    """Document -> sentences (reference ``SentenceSplitter.scala``)."""

    _pat = re.compile(r"(?<=[.!?])\s+")

    def apply(self, iterator):
        for doc in iterator:
            for s in self._pat.split(doc.strip()):
                if s:
                    yield s


class SentenceBiPadding(Transformer):
    """Wrap token lists with start/end markers
    (reference ``SentenceBiPadding.scala``)."""

    def apply(self, iterator):
        for tokens in iterator:
            yield [SENTENCE_START] + list(tokens) + [SENTENCE_END]


class Dictionary:
    """Word <-> index mapping built from a tokenized corpus
    (reference ``Dictionary.scala``). Index 0 is reserved for padding and
    the last index for <unk> when ``vocab_size`` truncates."""

    def __init__(self, sentences=None, vocab_size=None):
        self._word2idx = {PADDING: 0}
        self._idx2word = [PADDING]
        if sentences is not None:
            self._build(sentences, vocab_size)

    def _build(self, sentences, vocab_size):
        from collections import Counter
        counts = Counter()
        for tokens in sentences:
            counts.update(tokens)
        vocab = [w for w, _ in counts.most_common()]
        if vocab_size is not None:
            vocab = vocab[:max(vocab_size - 2, 0)]  # pad + unk
        for w in vocab:
            self._word2idx[w] = len(self._idx2word)
            self._idx2word.append(w)
        self._word2idx.setdefault(UNKNOWN, len(self._idx2word))
        if UNKNOWN not in self._idx2word:
            self._idx2word.append(UNKNOWN)

    def vocab_size(self):
        return len(self._idx2word)

    def get_index(self, word):
        return self._word2idx.get(word, self._word2idx[UNKNOWN])

    def get_word(self, index):
        return self._idx2word[int(index)]

    def to_indices(self, tokens):
        return np.asarray([self.get_index(t) for t in tokens], np.int32)

    def word2index(self):
        return dict(self._word2idx)

    def save(self, path):
        with open(path, "w") as f:
            for w in self._idx2word:
                f.write(w + "\n")

    @classmethod
    def load(cls, path):
        d = cls()
        with open(path) as f:
            words = [line.rstrip("\n") for line in f]
        d._idx2word = words
        d._word2idx = {w: i for i, w in enumerate(words)}
        return d


class LabeledSentence:
    """(data, label) index arrays (reference ``LabeledSentence.scala``)."""

    __slots__ = ("data", "label")

    def __init__(self, data, label):
        self.data = np.asarray(data, np.int32)
        self.label = np.asarray(label, np.int32)

    def data_length(self):
        return len(self.data)


class TextToLabeledSentence(Transformer):
    """Token list -> next-word-prediction LabeledSentence
    (reference ``TextToLabeledSentence.scala``)."""

    def __init__(self, dictionary):
        self.dictionary = dictionary

    def apply(self, iterator):
        for tokens in iterator:
            idx = self.dictionary.to_indices(tokens)
            if len(idx) < 2:
                continue
            yield LabeledSentence(idx[:-1], idx[1:])


class LabeledSentenceToSample(Transformer):
    """Pad/truncate LabeledSentences into fixed-length Samples
    (reference ``LabeledSentenceToSample.scala``): every batch of one
    shape, as the reference's padding params give."""

    def __init__(self, fixed_length, padding_value=0):
        self.fixed_length = fixed_length
        self.padding_value = padding_value

    def apply(self, iterator):
        n = self.fixed_length
        for ls in iterator:
            data = np.full((n,), self.padding_value, np.int32)
            label = np.full((n,), self.padding_value, np.int32)
            ln = min(len(ls.data), n)
            data[:ln] = ls.data[:ln]
            label[:ln] = ls.label[:ln]
            yield Sample(data, label)


def ptb_batches(word_ids, batch_size, num_steps):
    """Contiguous LM batching (reference ``PTBWordLM.scala`` /
    ``SequencePreprocess``): reshape the id stream into ``batch_size``
    parallel streams and slice (x, y) windows of ``num_steps``."""
    word_ids = np.asarray(word_ids, np.int32)
    n_batches = (len(word_ids) - 1) // (batch_size * num_steps)
    if n_batches == 0:
        raise ValueError("corpus too small for batch_size x num_steps")
    usable = n_batches * batch_size * num_steps
    xs = word_ids[:usable].reshape(batch_size, -1)
    ys = word_ids[1:usable + 1].reshape(batch_size, -1)
    for i in range(n_batches):
        s = slice(i * num_steps, (i + 1) * num_steps)
        yield xs[:, s], ys[:, s]


__all__ = ["Dictionary", "LabeledSentence", "LabeledSentenceToSample",
           "PADDING", "SENTENCE_END", "SENTENCE_START", "SentenceBiPadding",
           "SentenceSplitter", "SentenceTokenizer", "TextToLabeledSentence",
           "UNKNOWN", "ptb_batches", "read_localfile"]
