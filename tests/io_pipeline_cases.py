"""Decoders shared by the io_pipeline tests on the CPU and on the card.

They are picklable and live in a module of their own that imports neither
package when it is imported, so that a spawn worker which unpickles one
imports only the package it decodes for.
"""
import importlib

import numpy as np

N_REC, FEAT = 37, 12


def _iop(package):
    return importlib.import_module(package + ".io_pipeline")


class NoisyDecoder:
    """The record's array plus one per-record uniform draw per element:
    exercises the seeded augmentation stream, not only the order."""

    def __init__(self, package, shape=(FEAT,)):
        self._inner = _iop(package).NDArrayRecordDecoder(shape)

    def __call__(self, raw, rng):
        data, label = self._inner(raw, rng)
        return data + rng.uniform(0.0, 1.0, data.shape).astype(
            np.float32), label


class ExplodingDecoder:
    """Raises on the record whose header id is ``bad_id``."""

    def __init__(self, package, bad_id=3, shape=(FEAT,)):
        self.package = package
        self.bad_id = bad_id
        self._inner = _iop(package).NDArrayRecordDecoder(shape)

    def __call__(self, raw, rng):
        recordio = importlib.import_module(self.package + ".recordio")
        header, _ = recordio.unpack(raw)
        if header.id == self.bad_id:
            raise ValueError("boom on record %d" % self.bad_id)
        return self._inner(raw, rng)


class CudaStateDecoder(NoisyDecoder):
    """NoisyDecoder whose label is whether CUDA is initialized in the
    process that decodes (1.0) or not (0.0)."""

    def __call__(self, raw, rng):
        import torch
        data, _ = super().__call__(raw, rng)
        return data, float(torch.cuda.is_initialized())


def _refuse_to_start():
    raise RuntimeError("this decoder cannot start in a worker process")


class BrokenInWorker(NoisyDecoder):
    """Decodes in the parent; unpickling it in a worker raises, so a
    process pool over it cannot start."""

    def __reduce__(self):
        return (_refuse_to_start, ())
