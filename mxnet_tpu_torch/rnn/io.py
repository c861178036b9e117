"""Bucketing language-model data utilities (counterpart of
``mxnet_tpu.rnn.io``; reference:
python/mxnet/rnn/io.py:30-211 — encode_sentences + BucketSentenceIter,
the feeder for BucketingModule LM training)."""
from __future__ import annotations

import bisect
import random

import numpy as np

from ..io import DataIter, DataBatch, DataDesc
from ..ndarray import array as nd_array

__all__ = ["encode_sentences", "BucketSentenceIter"]


def encode_sentences(sentences, vocab=None, invalid_label=-1,
                     invalid_key="\n", start_label=0, unknown_token=None):
    """Token-lists -> int-lists, growing ``vocab`` as needed (reference
    io.py:30).  Returns (encoded, vocab)."""
    idx = start_label
    new_vocab = vocab is None
    if new_vocab:
        vocab = {invalid_key: invalid_label}
    res = []
    for sent in sentences:
        coded = []
        for word in sent:
            if word not in vocab:
                assert new_vocab or unknown_token, \
                    "Unknown token %s" % word
                if idx == invalid_label:
                    idx += 1
                if unknown_token:
                    word = unknown_token
                vocab[word] = idx
                idx += 1
            coded.append(vocab[word])
        res.append(coded)
    return res, vocab


class BucketSentenceIter(DataIter):
    """Pads each sentence to its bucket length and serves per-bucket
    batches with ``bucket_key`` attached; label is the input shifted one
    step left (next-token LM).  Reference io.py:84.  ``reset`` shuffles
    with Python's and numpy's global generators on the host, as the
    reference does, so the same seeds give the same batches."""

    def __init__(self, sentences, batch_size, buckets=None,
                 invalid_label=-1, data_name="data",
                 label_name="softmax_label", dtype="float32", layout="NT"):
        super().__init__(batch_size)
        if not buckets:
            # auto-buckets: every length with at least a batch of sentences
            buckets = [i for i, j in
                       enumerate(np.bincount([len(s) for s in sentences]))
                       if j >= batch_size]
        buckets = sorted(buckets)
        assert buckets, "no buckets: pass buckets= or lower batch_size"

        self.data = [[] for _ in buckets]
        ndiscard = 0
        used = set()
        for sent in sentences:
            buck = bisect.bisect_left(buckets, len(sent))
            if buck == len(buckets):
                ndiscard += 1
                continue
            used.add(buck)
            buff = np.full((buckets[buck],), invalid_label, dtype=dtype)
            buff[:len(sent)] = sent
            self.data[buck].append(buff)
        buckets = [b for i, b in enumerate(buckets) if i in used]
        self.data = [np.asarray(d, dtype=dtype) for d in self.data if d]
        if ndiscard:
            print("WARNING: discarded %d sentences longer than the largest "
                  "bucket." % ndiscard)

        self.buckets = buckets
        self.data_name = data_name
        self.label_name = label_name
        self.dtype = dtype
        self.invalid_label = invalid_label
        self.major_axis = layout.find("N")
        self.layout = layout
        self.default_bucket_key = max(buckets)

        shape = (batch_size, self.default_bucket_key) \
            if self.major_axis == 0 else \
            (self.default_bucket_key, batch_size)
        if self.major_axis not in (0, 1):
            raise ValueError("Invalid layout %s: Must be NT (batch major) "
                             "or TN (time major)" % layout)
        self.provide_data = [DataDesc(data_name, shape, layout=layout)]
        self.provide_label = [DataDesc(label_name, shape, layout=layout)]

        self.idx = []
        for i, buck in enumerate(self.data):
            self.idx.extend([(i, j) for j in
                             range(0, len(buck) - batch_size + 1,
                                   batch_size)])
        self.curr_idx = 0
        self.nddata = []
        self.ndlabel = []
        self.reset()

    def reset(self):
        self.curr_idx = 0
        random.shuffle(self.idx)
        for buck in self.data:
            np.random.shuffle(buck)
        self.nddata = []
        self.ndlabel = []
        for buck in self.data:
            label = np.empty_like(buck)
            label[:, :-1] = buck[:, 1:]
            label[:, -1] = self.invalid_label
            self.nddata.append(nd_array(buck.astype(self.dtype)))
            self.ndlabel.append(nd_array(label.astype(self.dtype)))

    def next(self):
        if self.curr_idx == len(self.idx):
            raise StopIteration
        i, j = self.idx[self.curr_idx]
        self.curr_idx += 1
        data = self.nddata[i][j:j + self.batch_size]
        label = self.ndlabel[i][j:j + self.batch_size]
        if self.major_axis == 1:
            data = data.T
            label = label.T
        batch = DataBatch(
            [data], [label], pad=0,
            provide_data=[DataDesc(self.data_name, data.shape,
                                   layout=self.layout)],
            provide_label=[DataDesc(self.label_name, label.shape,
                                    layout=self.layout)])
        batch.bucket_key = self.buckets[i]
        return batch
