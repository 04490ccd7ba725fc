"""The chunked Trainer's batch stream (`Batches.next_chunk`, K batches
stacked a call) against the JAX Trainer's `next_batch` at
`parallel.steps_per_call` 3 (after its device_put), on the CPU, host-side
numpy only: a JAX `Trainer` is built and loaded, nothing is compiled.

For each shape mode, bucket pairing, `io.seq_len` and batch mix, the port's
`Batches` and the JAX Trainer load the same synthetic data set with the
same seed and give five chunks that are equal array for array (bitwise,
dtypes and the leading K included): one bucket a chunk ('matched'), a
bucket and an independent fake bucket ('independent'), `io.seq_len`, or
batch_mix='sample' batches of the padded shape. The per-batch stream goes on
alike after the chunks.
"""

import numpy as np
import pytest

from scrabblegan_tpu.config import load_config
from scrabblegan_torch.config import load_config as port_load_config
from scrabblegan_torch.train.batches import Batches
from test_torch_batches import BASE, assert_same_batch, data  # noqa: F401 - a fixture

K = 3
CASES = {
    "bucketed matched": {},
    "bucketed independent": {"parallel.bucket_pairing": "independent"},
    "padded independent": {"parallel.shape_mode": "padded",
                           "parallel.bucket_pairing": "independent"},
    "padded sample": {"parallel.shape_mode": "padded", "parallel.batch_mix": "sample"},
    "seq_len": {"io.seq_len": "2"},
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_chunks_equal_the_jax_trainer_s(tmp_path, data, case):  # noqa: F811
    from scrabblegan_tpu.train.loop import Trainer

    overrides = {**BASE, **CASES[case], "parallel.steps_per_call": str(K)}
    ref = Trainer(load_config(None, overrides), workdir=str(tmp_path / "jax"), verbose=False)
    ref.load_data(**data)
    port = Batches(port_load_config(None, overrides))
    port.load(**data)
    for i in range(5):
        got = port.next_chunk(K)
        assert all(v.shape[0] == K for v in got.values())
        assert_same_batch(got, ref.next_batch(), f"{case} chunk {i}")
        if "real_lengths" in got and CASES[case].get("parallel.batch_mix") != "sample":
            assert len(np.unique(got["real_lengths"])) == 1  # one bucket a chunk
    assert_same_batch(port.assemble(), ref._assemble(), f"{case} after the chunks")
    np.testing.assert_array_equal(port.np_rng.integers(0, 1 << 30, 4),
                                  ref.np_rng.integers(0, 1 << 30, 4))
