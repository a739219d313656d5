"""Port parity: the data pipeline (repro_torch.data, a numpy copy of
repro.data.pipeline).  Ports of tests/test_data.py, each batch also held
byte for byte to the reference's on the same arguments."""

import numpy as np
import pytest

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.data import pipeline as ref  # noqa: E402
from repro_torch.data.pipeline import (  # noqa: E402
    EOS,
    HostDataLoader,
    SyntheticTokenDataset,
    pack_documents,
)


def _same_bytes(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def test_loader_deterministic_across_instances():
    ds = SyntheticTokenDataset(vocab=512)
    a = HostDataLoader(ds, global_batch=4, seq_len=64)
    b = HostDataLoader(ds, global_batch=4, seq_len=64)
    ta, la = next(a)
    tb, lb = next(b)
    np.testing.assert_array_equal(ta, tb)
    np.testing.assert_array_equal(la, lb)


def test_loader_resume_continues_stream():
    ds = SyntheticTokenDataset(vocab=512)
    a = HostDataLoader(ds, global_batch=2, seq_len=32)
    next(a)
    state = a.state_dict()
    t2, _ = next(a)
    b = HostDataLoader(ds, global_batch=2, seq_len=32)
    b.load_state_dict(state)
    t2b, _ = next(b)
    np.testing.assert_array_equal(t2, t2b)


def test_shards_are_disjoint():
    ds = SyntheticTokenDataset(vocab=512)
    a = HostDataLoader(ds, global_batch=8, seq_len=32, shard_index=0, num_shards=2)
    b = HostDataLoader(ds, global_batch=8, seq_len=32, shard_index=1, num_shards=2)
    ta, _ = next(a)
    tb, _ = next(b)
    assert ta.shape == tb.shape == (4, 32)
    assert not np.array_equal(ta, tb)


@given(seq_len=st.integers(8, 128), batch=st.integers(1, 8))
@settings(max_examples=20, deadline=None)
def test_packing_shapes_and_label_shift(seq_len, batch):
    ds = SyntheticTokenDataset(vocab=512, mean_doc_len=20)
    tokens, labels = pack_documents(ds.documents(shard=0), seq_len, batch)
    assert tokens.shape == (batch, seq_len)
    assert labels.shape == (batch, seq_len)
    # labels are tokens shifted by one within the packed row
    np.testing.assert_array_equal(tokens[:, 1:], labels[:, :-1])
    assert tokens.max() < 512 and tokens.min() >= 0
    rt, rl = ref.pack_documents(ref.SyntheticTokenDataset(vocab=512, mean_doc_len=20)
                                .documents(shard=0), seq_len, batch)
    _same_bytes(tokens, rt)
    _same_bytes(labels, rl)


@pytest.mark.parametrize("vocab,batch,seq,shards,seed", [
    (512, 4, 64, 1, 1234), (151936, 8, 128, 1, 1234), (50280, 8, 32, 2, 7),
    (1000, 3, 17, 3, 99)])
def test_batches_equal_the_reference_byte_for_byte(vocab, batch, seq, shards, seed):
    for shard in range(shards):
        port = HostDataLoader(SyntheticTokenDataset(vocab=vocab, seed=seed), global_batch=batch
                              * shards, seq_len=seq, shard_index=shard, num_shards=shards)
        want = ref.HostDataLoader(ref.SyntheticTokenDataset(vocab=vocab, seed=seed),
                                  global_batch=batch * shards, seq_len=seq,
                                  shard_index=shard, num_shards=shards)
        for _ in range(3):
            (t, lab), (rt, rl) = next(port), next(want)
            _same_bytes(t, rt)
            _same_bytes(lab, rl)
        assert port.state_dict() == want.state_dict()


def test_documents_and_eos_match_the_reference():
    port = SyntheticTokenDataset(vocab=300, mean_doc_len=30).documents(shard=5, start_doc=2)
    want = ref.SyntheticTokenDataset(vocab=300, mean_doc_len=30).documents(shard=5, start_doc=2)
    for _ in range(10):
        _same_bytes(next(port), next(want))
    assert EOS == ref.EOS == 0
