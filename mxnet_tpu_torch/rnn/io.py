"""The bucketing iterator for variable-length sentences.

Counterpart of ``mxnet_tpu/rnn/io.py`` (ref: python/mxnet/rnn/io.py
``BucketSentenceIter``).  Sentences are grouped into length buckets, so
that each bucket is one fixed shape: one bound executor and, on the
card, one CUDA graph of the fused train step per bucket.  Each bucket
is a padded matrix on the host; the next-token labels are one shifted
copy made at reset, and the time-major layout is one transpose at emit.
The shuffles draw from python's ``random`` and numpy's global generator,
as the JAX package's do, so a seed gives the same batches in both.
"""
from __future__ import annotations

import logging
import random

import numpy as np

from ..context import cpu
from ..io import DataIter, DataBatch, DataDesc
from ..ndarray import array as nd_array


def _auto_buckets(lengths, min_count):
    """One bucket per sentence length that can fill a batch."""
    counts = np.bincount(lengths)
    return [size for size, n in enumerate(counts) if n >= min_count]


class BucketSentenceIter(DataIter):
    """Language-model iterator: data is the sentence, label the sentence
    shifted left by one, both padded with ``invalid_label``."""

    def __init__(self, sentences, batch_size, buckets=None,
                 invalid_label=-1, data_name="data",
                 label_name="softmax_label", dtype="float32", layout="NT"):
        super().__init__(batch_size)
        self.batch_size = batch_size
        self.data_name = data_name
        self.label_name = label_name
        self.dtype = dtype
        self.invalid_label = invalid_label
        self.layout = layout
        self.major_axis = layout.find("N")
        if self.major_axis not in (0, 1):
            raise ValueError("Invalid layout %s: Must by NT (batch major) "
                             "or TN (time major)" % layout)

        self.buckets = sorted(buckets or _auto_buckets(
            [len(s) for s in sentences], batch_size))
        self.default_bucket_key = max(self.buckets)
        self.data = self._bucketize(sentences)

        # fixed (bucket, offset) schedule; only full batches are emitted
        self.idx = [(b, off)
                    for b, rows in enumerate(self.data)
                    for off in range(0, len(rows) - batch_size + 1,
                                     batch_size)]
        self.curr_idx = 0

        full_shape = ((batch_size, self.default_bucket_key)
                      if self.major_axis == 0
                      else (self.default_bucket_key, batch_size))
        self.provide_data = [DataDesc(name=data_name, shape=full_shape,
                                      layout=layout)]
        self.provide_label = [DataDesc(name=label_name, shape=full_shape,
                                       layout=layout)]
        self.reset()

    def _bucketize(self, sentences):
        """Pad each sentence into the smallest bucket that holds it."""
        per_bucket = [[] for _ in self.buckets]
        dropped = 0
        for sentence in sentences:
            slot = np.searchsorted(self.buckets, len(sentence))
            if slot == len(self.buckets):
                dropped += 1
                continue
            row = np.full((self.buckets[slot],), self.invalid_label,
                          dtype=self.dtype)
            row[:len(sentence)] = sentence
            per_bucket[slot].append(row)
        if dropped:
            logging.warning("discarded %d sentences longer than the "
                            "largest bucket.", dropped)
        # empty buckets keep a (0, width) shape so downstream 2-D slicing
        # holds (np.asarray([]) would collapse to 1-D)
        return [np.asarray(rows, dtype=self.dtype) if rows
                else np.empty((0, width), self.dtype)
                for rows, width in zip(per_bucket, self.buckets)]

    def reset(self):
        self.curr_idx = 0
        random.shuffle(self.idx)
        self.nddata, self.ndlabel = [], []
        for rows in self.data:
            np.random.shuffle(rows)
            # next-token label: shift left, pad the tail position
            shifted = np.full_like(rows, self.invalid_label)
            shifted[:, :-1] = rows[:, 1:]
            self.nddata.append(nd_array(rows, ctx=cpu(), dtype=self.dtype))
            self.ndlabel.append(nd_array(shifted, ctx=cpu(),
                                         dtype=self.dtype))

    def next(self):
        if self.curr_idx >= len(self.idx):
            raise StopIteration
        bucket, off = self.idx[self.curr_idx]
        self.curr_idx += 1
        sl = slice(off, off + self.batch_size)
        data = self.nddata[bucket][sl]
        label = self.ndlabel[bucket][sl]
        if self.major_axis == 1:  # time-major
            data, label = data.T, label.T
        return DataBatch(
            [data], [label], pad=0, bucket_key=self.buckets[bucket],
            provide_data=[DataDesc(name=self.data_name, shape=data.shape,
                                   layout=self.layout)],
            provide_label=[DataDesc(name=self.label_name,
                                    shape=label.shape,
                                    layout=self.layout)])
