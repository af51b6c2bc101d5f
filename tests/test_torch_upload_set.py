"""The staged upload of a text set: the threaded fill of a staging buffer.

``myers_torch._fill`` copies a byte range of the concatenation of many
host arrays into a staging buffer on up to one host thread per intra-op
thread of PyTorch (``csrc/stage_fill.cc``, built with g++); here, on the
CPU, it is held to ``np.concatenate`` at
chunk edges inside texts, over empty texts, a text longer than a chunk,
read-only ``bytes`` and reversed views, and driven through
``_upload_set`` with a staging of plain CPU tensors.
"""

import threading

import numpy as np
import pytest
import torch

from sassy_tpu_torch.ops import myers_torch


def _texts(rng, chunk: int) -> list:
    """Random texts of 0-3 chunks' length, runs of empty ones, read-only
    views of ``bytes`` and reversed views, as ``TextSet`` holds them."""
    texts = []
    for i in range(60):
        n = int(rng.choice([0, 1, 7, 100, chunk // 3, chunk + 5, 3 * chunk]))
        a = rng.integers(0, 256, n, np.uint8)
        texts.append(np.frombuffer(a.tobytes(), np.uint8) if i % 7 == 3
                     else a[::-1] if i % 5 == 1 else a)
    return texts + [np.zeros(0, np.uint8)] * 3


@pytest.mark.parametrize("threads", [1, 2, 3, 8])
def test_fill_equals_the_concatenation(monkeypatch, threads):
    """Every byte range that a staging chunk of 1,000 bytes covers, and
    ranges starting and ending inside texts: the buffer holds the
    concatenation's bytes, on one thread per intra-op thread of PyTorch
    but no more than the texts the range holds, and nothing outside the
    range is written."""
    monkeypatch.setattr(torch, "get_num_threads", lambda: threads)
    rng = np.random.default_rng(threads)
    texts = _texts(rng, 1_000)
    offs = np.concatenate([[0], np.cumsum([len(t) for t in texts])])
    whole = np.concatenate(texts)
    n = int(offs[-1])
    ranges = [(c0, min(n, c0 + 1_000)) for c0 in range(0, n, 1_000)]
    ranges += [(int(offs[5]) + 1, int(offs[40]) - 1), (0, n), (n - 3, n)]
    for c0, c1 in ranges:
        buf = np.full(c1 - c0 + 8, 0xAA, np.uint8)
        used = myers_torch._fill(texts, offs, c0, c1, buf[4:-4])
        np.testing.assert_array_equal(buf[4:-4], whole[c0:c1])
        assert (buf[:4] == 0xAA).all() and (buf[-4:] == 0xAA).all()
        parts = len(myers_torch._chunk_pieces(texts, offs, c0, c1))
        assert used == min(threads, parts)


def test_fill_refuses_what_it_cannot_copy():
    """A text that is not a 1-D byte buffer of its length, and a range
    outside the texts, raise with nothing copied past the range."""
    texts = [np.arange(10, dtype=np.uint8), np.zeros((2, 3), np.uint8)]
    offs = np.array([0, 10, 16])
    out = np.zeros(16, np.uint8)
    with pytest.raises(ValueError, match="text 1"):
        myers_torch._fill(texts, offs, 0, 16, out)
    with pytest.raises(ValueError, match="outside"):
        myers_torch._fill(texts[:1], offs[:2], 4, 12, np.zeros(8, np.uint8))
    with pytest.raises(ValueError, match="contiguous"):
        myers_torch._fill(texts[:1], offs[:2], 0, 10, out[::2][:10][::-1])


class _CheckedStaging:
    """The staging's interface on the CPU: each send checks that its
    buffer holds the chunk's bytes (every thread of the fill done) and
    that the buffer was waited for since its previous send."""

    def __init__(self, nbytes: int, whole: np.ndarray):
        self.bufs = [torch.full((nbytes,), 0xAA, dtype=torch.uint8)
                     for _ in range(2)]
        self.lock = threading.Lock()
        self.whole = whole
        self.waited = [True, True]
        self.sends = 0
        self.out = None

    def begin(self, out):
        self.out = out

    def wait(self, slot):
        self.waited[slot] = True

    def send(self, slot, dst, n):
        assert self.waited[slot]
        self.waited[slot] = False
        c0 = (dst.data_ptr() - self.out.data_ptr())
        np.testing.assert_array_equal(self.bufs[slot][:n].numpy(),
                                      self.whole[c0 : c0 + n])
        dst.copy_(self.bufs[slot][:n])
        self.sends += 1

    def end(self, out):
        pass


@pytest.mark.parametrize("chunk", [64, 1_000, 1 << 14])
def test_set_upload_through_the_threaded_fill(monkeypatch, chunk):
    """``_upload_set`` through a staging of CPU tensors, chunks filled on
    four threads: every chunk complete when it is sent, each buffer waited
    for before it is refilled, the device bytes the concatenation."""
    monkeypatch.setattr(torch, "get_num_threads", lambda: 4)
    monkeypatch.setattr(myers_torch, "STAGE_BYTES", chunk)
    rng = np.random.default_rng(chunk)
    texts = _texts(rng, chunk)
    whole = np.concatenate(texts)
    staging = _CheckedStaging(chunk, whole)
    monkeypatch.setattr(myers_torch, "_staging_for", lambda device: staging)
    got = myers_torch._upload_set(texts, torch.device("cpu"))
    np.testing.assert_array_equal(got.numpy(), whole)
    assert staging.sends == -(-len(whole) // chunk)
