"""The port's data pipeline against the JAX package's: every host's batches
from any ``start_step``, at 1, 2, 4 and 8 hosts, byte for byte; the cursor
counts what was consumed, not what was prefetched; a desync is loud.
Twins of ``tests/test_data_replay.py``'s cases run on the port's
``Pipeline``."""
import dataclasses

import numpy as np
import pytest

from repro.data import pipeline as jpipe
from repro_torch.data import (DataConfig, Pipeline, SyntheticCorpus,
                              global_batch, make_pipeline)
import torch_one_thread  # noqa: F401  (one intra-op thread: tests/torch_one_thread.py)

KW = dict(vocab_size=256, seq_len=32, global_batch=8, seed=0)
CFG = DataConfig(**KW)


def _drain(pipe, n):
    try:
        return [next(pipe) for _ in range(n)]
    finally:
        pipe.close()


@pytest.mark.parametrize("start_step", [0, 3, 11])
@pytest.mark.parametrize("n_hosts", [1, 2, 4, 8])
def test_host_batches_from_any_step_match_jax(n_hosts, start_step):
    """Each host's ``Pipeline(cfg, start_step)`` hands out the reference
    ``Pipeline``'s batches, byte for byte, and both cursors agree."""
    for h in range(n_hosts):
        kw = dict(KW, n_hosts=n_hosts, host_id=h)
        got_pipe = Pipeline(DataConfig(**kw), start_step=start_step)
        want_pipe = jpipe.Pipeline(jpipe.DataConfig(**kw), start_step=start_step)
        assert got_pipe.cursor == want_pipe.cursor == start_step
        got, want = _drain(got_pipe, 3), _drain(want_pipe, 3)
        assert got_pipe.cursor == want_pipe.cursor == start_step + 3
        for g, w in zip(got, want):
            assert g.shape == (8 // n_hosts, 32) and g.dtype == w.dtype
            assert g.tobytes() == w.tobytes()


@pytest.mark.parametrize("step", [0, 5, 11])
def test_global_batch_matches_jax_whatever_the_split(step):
    for n_hosts in (1, 2, 4, 8):
        kw = dict(KW, n_hosts=n_hosts, host_id=n_hosts - 1)
        assert global_batch(DataConfig(**kw), step).tobytes() == \
            jpipe.global_batch(jpipe.DataConfig(**kw), step).tobytes()


def test_one_host_batches_are_unchanged_by_the_host_split():
    """``n_hosts = 1`` (the default) gives the global batch: the trainer's
    batches are what they were before the split existed."""
    for step in range(3):
        np.testing.assert_array_equal(SyntheticCorpus(CFG).batch(step),
                                      jpipe.global_batch(jpipe.DataConfig(**KW), step))


def test_restart_replays_bit_identically():
    first = _drain(Pipeline(CFG), 6)
    resumed = make_pipeline(CFG, start_step=3)
    assert resumed.cursor == 3
    for i, b in enumerate(_drain(resumed, 3)):
        np.testing.assert_array_equal(b, first[3 + i])


def test_cursor_tracks_consumption_not_prefetch():
    pipe = Pipeline(dataclasses.replace(CFG, prefetch=4))
    assert pipe.cursor == 0
    next(pipe)
    next(pipe)
    assert pipe.cursor == 2             # 2 consumed, whatever was prefetched
    resumed = Pipeline(CFG, start_step=pipe.cursor)
    np.testing.assert_array_equal(_drain(pipe, 1)[0], _drain(resumed, 1)[0])


def test_replay_identical_across_host_count_change():
    for step in (0, 5, 11):
        want = global_batch(CFG, step)
        for n_hosts in (1, 2, 4, 8):
            shards = [SyntheticCorpus(dataclasses.replace(
                          CFG, n_hosts=n_hosts, host_id=h)).batch(step)
                      for h in range(n_hosts)]
            np.testing.assert_array_equal(np.concatenate(shards), want)


def test_distinct_steps_and_rows_differ():
    b0, b1 = global_batch(CFG, 0), global_batch(CFG, 1)
    assert not np.array_equal(b0, b1)
    assert not np.array_equal(b0[0], b0[1])


def test_pipeline_desync_is_loud():
    pipe = Pipeline(CFG)
    next(pipe)
    pipe.cursor = 40                    # corrupt the cursor deliberately
    with pytest.raises(AssertionError, match="desync"):
        next(pipe)
    pipe.close()


def test_uneven_host_split_is_refused():
    with pytest.raises(ValueError, match="does not split into 3 hosts"):
        DataConfig(**dict(KW, n_hosts=3)).per_host
