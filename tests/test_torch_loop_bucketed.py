"""The port's epoch Trainer in 'bucketed' shape mode: the checks of
test_torch_loop.py (artifact set, epoch-numbered exports, resume at
step 4 // 2 batches = epoch 2, one host fetch a flush block) on a run whose
batches have one word length each, drawn by bucket population. A file of
its own so that the two full-width CPU runs go to two test workers."""

import pytest

import test_torch_loop as base
from test_torch_loop import (data, test_artifact_set_and_epoch_numbered_exports,  # noqa: F401
                             test_one_host_fetch_a_flush_block,
                             test_resume_starts_at_the_checkpoint_s_epoch)


@pytest.fixture(scope="module")
def runs(data, tmp_path_factory):  # noqa: F811
    return base.train_and_resume("bucketed", data, tmp_path_factory.mktemp("bucketed"))
