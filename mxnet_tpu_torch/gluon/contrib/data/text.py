"""Language-model datasets (counterpart of
``mxnet_tpu.gluon.contrib.data.text``; reference
``gluon/contrib/data/text.py``): ``WikiText2`` and ``WikiText103``.

Nothing is downloaded: ``root`` must hold the extracted
``wiki.{train,valid,test}.tokens``, and a missing file raises
``FileNotFoundError``.  Tokens are whitespace-split with ``<eos>`` after
each line; a sample is ``(x, y)``, ``seq_len`` int32 ids and the same
shifted by one.  Without ``vocab`` the ids come from the corpus's own
vocabulary, indexed as the reference's ``Vocabulary``: ``<unk>`` 0, then
by falling frequency, ties in alphabetical order.
"""
from __future__ import annotations

import os
from collections import Counter

import numpy as np

from ...data.dataset import Dataset

__all__ = ["WikiText2", "WikiText103"]


class _Vocabulary:
    """The indexing of the reference's ``contrib.text.Vocabulary`` built
    from a counter (its other options are not needed here)."""

    def __init__(self, counter, unknown_token="<unk>"):
        self.idx_to_token = [unknown_token] + [
            t for t, _ in sorted(counter.items(),
                                 key=lambda kv: (-kv[1], kv[0]))
            if t != unknown_token]
        self.token_to_idx = {t: i for i, t in enumerate(self.idx_to_token)}

    def __len__(self):
        return len(self.idx_to_token)

    def to_indices(self, tokens):
        return [self.token_to_idx.get(t, 0) for t in tokens]


class _WikiText(Dataset):
    _files = {"train": "wiki.train.tokens", "validation": "wiki.valid.tokens",
              "test": "wiki.test.tokens"}
    _name = "wikitext"

    def __init__(self, root, segment="train", seq_len=35, vocab=None):
        path = os.path.join(os.path.expanduser(root), self._files[segment])
        if not os.path.exists(path):
            raise FileNotFoundError(
                "%s not found. Extract the %s archive into %r (nothing is "
                "downloaded)." % (path, self._name, root))
        with open(path, encoding="utf-8") as f:
            words = []
            for line in f:
                words.extend(line.split())
                words.append("<eos>")
        if vocab is None:
            vocab = _Vocabulary(Counter(words))
        self.vocab = vocab
        idx = np.asarray(vocab.to_indices(words), np.int32)
        n = (len(idx) - 1) // seq_len * seq_len
        self._x = idx[:n].reshape(-1, seq_len)
        self._y = idx[1:n + 1].reshape(-1, seq_len)

    def __getitem__(self, i):
        return self._x[i], self._y[i]

    def __len__(self):
        return len(self._x)


class WikiText2(_WikiText):
    _name = "wikitext-2"


class WikiText103(_WikiText):
    _name = "wikitext-103"
