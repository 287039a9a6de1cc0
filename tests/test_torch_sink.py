"""The sample sink of the torch port against the JAX package's: a file
written by either package, with either package's compiled writer or its
numpy writer, reads back bitwise in the other's ``read_samples``."""

import numpy as np
import pytest
import torch

from physicsbasedbayesianinference_tpu import native as jn
from physicsbasedbayesianinference_tpu_torch import native as tn


def _chunks(w=16, d=3, rows=5):
    rng = np.random.default_rng(11)
    return [rng.normal(size=(w, d)).astype(np.float32) for _ in range(rows)]


@pytest.mark.parametrize("native_writer", [True, False])
@pytest.mark.parametrize("writer, reader", [(tn, jn), (jn, tn)])
def test_files_read_bitwise_across_packages(tmp_path, monkeypatch, writer,
                                            reader, native_writer):
    if native_writer:
        assert writer.get_lib() is not None  # the compiler is here
    else:
        monkeypatch.setattr(writer, "get_lib", lambda: None)
    chunks = _chunks()
    path = str(tmp_path / "s.pbbi")
    with writer.SampleSink(path, 16, 3) as sink:
        for c in chunks:
            total = sink.append(c)
    assert total == 80
    want = np.concatenate(chunks)
    for read in (reader.read_samples, writer.read_samples):
        got = np.asarray(read(path))
        assert got.dtype == np.float32 and got.shape == (80, 3)
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))
    # the 32-byte header: magic, version 1, walkers, dims, rows
    head = np.fromfile(path, np.uint32, count=8)
    np.testing.assert_array_equal(head[:6], [0x50424249, 1, 16, 3, 80, 0])


def test_sink_takes_tensors_and_rejects_garbage(tmp_path):
    path = str(tmp_path / "t.pbbi")
    q = torch.arange(12, dtype=torch.float64).reshape(4, 3)
    with tn.SampleSink(path, 4, 3) as sink:
        sink.append(q)
        assert sink.append(q[None] + 1) == 8
    got = tn.read_samples(path)
    np.testing.assert_array_equal(got[:4], q.float().numpy())
    np.testing.assert_array_equal(got[4:], q.float().numpy() + 1)
    bad = tmp_path / "bad.bin"
    bad.write_bytes(b"not a sample file, not at all, no")
    with pytest.raises(ValueError, match="PBBI"):
        tn.read_samples(str(bad))
